// Flash attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: tensor2robot_tpu/ops/attention.py `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (launched by `_flash_bwd`, the custom VJP of
// `_flash`), the Pallas TPU kernels behind the gradient of
// `flash_attention`, run by every train step of the causal sequence policy
// with attention_backend='flash'.
//
// What they compute, per (batch*head): with S = Q.K^T * scale, the causal
// triangle and the key/row padding mask of `valid_len`,
//   P  = exp(S - lse)            (0 on masked entries, masked BEFORE exp:
//                                 padded rows carry lse = 0, where exp(S)
//                                 could overflow)
//   dP = dO.V^T,   dS = P * (dP - delta) * scale,   delta = rowsum(dO * O)
//   dQ = dS.K,     dK = dS^T.Q,  dV = P^T.dO.
// Inputs are f32 or bf16. P, dP and dS are kept to f32 accuracy (the TPU
// kernels widen dO and keep P/dS in f32; unlike the forward, nothing is
// rounded to bf16 once before a product). dQ, dK and dV are cast to the
// input dtype once, at the end. lse and delta are f32 [BH, T].
//
// The FlashAttention-2 split of the TPU package: the dQ kernel loops over
// key tiles per query tile up to the diagonal; the dK/dV kernel loops over
// query tiles per key tile, from the diagonal tile (the tile holding row
// k_start) to the last tile with a valid row. Each output element is
// written by exactly one block: no atomics, deterministic results.
//
// What bounds them on an H100: operations. At the training shape (BH = 16,
// T = 4096, D = 64, causal) dQ does 3 products (S, dP, dQ) and dK/dV 4
// (S, dP, dV, dK) of 2*BH*T^2*D/2 = 17.2 GFLOP each, on ~45 MB of operands.
//
// Designs, chosen by kernel and dtype inside the launch functions:
//
// * bf16: tensor cores. Both kernels run their products as `wgmma` on two
//   consumer warpgroups of 64 rows each (one at D 128, where the
//   accumulators take 64 or 128 registers a thread), fed by a producer warp
//   that issues TMA loads (3-D maps, so a tile never reads past its head):
//   the kernel's own 64-row blocks once, the streamed operand through a
//   2-stage ring of full/empty mbarriers. The two score products run from
//   shared memory (SS), K-major as stored. Their accumulators are already
//   the A-operand register layout of the next product (`wgmma` RS), whose
//   B operand is a resident or streamed tile read MN-major through a second
//   descriptor of the same buffer, so P and dS never go through shared
//   memory. A bf16 product rounds its A operand, and rounding P or dS once
//   moves dQ, dK and dV 18-33x further from the f32 function than the
//   split does (tests/test_torch_flash_numerics.py); so each is split into
//   bf16 hi + lo (about 16 mantissa bits) and fed as two products. head_dim
//   16 and 32 are computed at 64 (TMA fills the missing columns with
//   zeros).
//   - dQ (`flash_bwd_dq_tc_kernel`): one CTA per (BH, 128-query tile; 64 at
//     D 128), longest causal tiles first; Q and dO resident, the rows' lse
//     (log2 domain) and delta in registers; K and V tiles of 64 keys
//     streamed from key tile 0 to the diagonal. S = Q.K^T and dP = dO.V^T
//     by m64n64k16 SS, dS = P * (dP - delta) * scale in registers, dQ +=
//     (dS_hi + dS_lo).K with K read MN-major.
//   - dK/dV (`flash_bwd_dkv_tc_kernel`): one CTA per (BH, 128-key tile; 64
//     at D 128); K and V resident, 64-row Q and dO tiles with their lse and
//     delta streamed. Scores are computed transposed, keys as M: S^T =
//     K.Q^T and dP^T = V.dO^T, then dV += (P^T_hi + P^T_lo).dO and dK +=
//     (dS^T_hi + dS^T_lo).Q, with dO and Q read MN-major.
// * f32: the f32 CUDA cores (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`),
//   exact f32 products. One thread block of 256 threads per 64-row tile,
//   four threads per tile row. Tiles are staged in shared memory with a
//   padded row stride (D + 1) so the four threads of a row and the eight
//   rows of a warp hit distinct banks. Each thread scores 16 columns of its
//   row (S and dP together, sharing the loop over D), writes P or dS to a
//   shared tile, and after a barrier accumulates D/4 output columns in
//   registers. Shared-memory reads (about one per FMA) limit them; the
//   3xTF32 split of the f32 forward (csrc/flash_fwd.cu) is their way onto
//   the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kTile = 64;                  // rows per tile (queries or keys)
constexpr int kSub = 4;                    // threads per tile row
constexpr int kThreads = kTile * kSub;     // 256
constexpr int kColsPerThread = kTile / kSub;  // 16 scored columns per thread

// Stages rows [row0, row0 + kTile) of a [T, D] head into a shared tile of
// stride D + 1; rows at or past t_len read as 0.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src,
                                           int row0, int t_len, int tid) {
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int row = row0 + rr;
    dst[rr * (D + 1) + dd] = row < t_len ? src[static_cast<size_t>(row) * D + dd] : 0.f;
  }
}

__device__ __forceinline__ bool entry_valid(int q_pos, int k_pos, int valid_len,
                                            int causal) {
  return q_pos < valid_len && k_pos < valid_len && (!causal || k_pos <= q_pos);
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * static_cast<size_t>(kTile) * (D + 1)      // Q, dO, K, V
         + static_cast<size_t>(kTile) * (kTile + 1);   // dS
}

// f32 dQ for one (BH, query tile). Thread (r, sub) owns query row r: it scores
// keys sub + 4i of each key tile and accumulates dQ columns sub + 4c.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int t_len, int valid_len, int causal,
                    float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * (D + 1);
  float* sK = sDO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sDS = sV + kTile * (D + 1);

  const int q_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / kSub;
  const int sub = tid % kSub;
  const int q_row = q_tile * kTile + r;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const size_t head_rows = static_cast<size_t>(bh) * t_len;

  stage_tile<D>(sQ, q + head, q_tile * kTile, t_len, tid);
  stage_tile<D>(sDO, dout + head, q_tile * kTile, t_len, tid);
  const bool row_valid = q_row < valid_len;
  const float lse_r = row_valid ? lse[head_rows + q_row] : 0.f;
  const float delta_r = row_valid ? delta[head_rows + q_row] : 0.f;

  // Key tiles holding a valid key, stopping at the diagonal; none for a
  // tile of padded rows (their dQ is 0).
  int num_tiles = (valid_len + kTile - 1) / kTile;
  if (causal) num_tiles = min(num_tiles, q_tile + 1);
  if (q_tile * kTile >= valid_len) num_tiles = 0;

  float acc[D / kSub];
#pragma unroll
  for (int c = 0; c < D / kSub; ++c) acc[c] = 0.f;

  for (int kt = 0; kt < num_tiles; ++kt) {
    __syncthreads();  // the previous tile's K and dS are consumed
    stage_tile<D>(sK, k + head, kt * kTile, t_len, tid);
    stage_tile<D>(sV, v + head, kt * kTile, t_len, tid);
    __syncthreads();

    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) { s[i] = 0.f; dp[i] = 0.f; }
    const float* q_r = sQ + r * (D + 1);
    const float* do_r = sDO + r * (D + 1);
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float qd = q_r[dd];
      const float dod = do_r[dd];
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) {
        const int j = sub + kSub * i;
        s[i] = fmaf(qd, sK[j * (D + 1) + dd], s[i]);
        dp[i] = fmaf(dod, sV[j * (D + 1) + dd], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int j = sub + kSub * i;
      const bool ok = entry_valid(q_row, kt * kTile + j, valid_len, causal);
      const float p = ok ? expf(s[i] * scale - lse_r) : 0.f;
      sDS[r * (kTile + 1) + j] = p * (dp[i] - delta_r) * scale;
    }
    __syncthreads();

    const float* ds_r = sDS + r * (kTile + 1);
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float ds = ds_r[j];
      const float* k_j = sK + j * (D + 1) + sub;
#pragma unroll
      for (int c = 0; c < D / kSub; ++c) acc[c] = fmaf(ds, k_j[kSub * c], acc[c]);
    }
  }

  if (q_row < t_len) {
    float* dq_r = dq + head + static_cast<size_t>(q_row) * D + sub;
#pragma unroll
    for (int c = 0; c < D / kSub; ++c) dq_r[kSub * c] = acc[c];
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * static_cast<size_t>(kTile) * (D + 1)      // K, V, Q, dO
         + 2 * static_cast<size_t>(kTile) * (kTile + 1)  // P^T, dS^T
         + 2 * static_cast<size_t>(kTile);             // lse, delta
}

// f32 dK and dV for one (BH, key tile). Thread (kr, sub) owns key row kr: it
// scores queries sub + 4m of each query tile and accumulates dK and dV
// columns sub + 4c.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int t_len,
                     int valid_len, int causal, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sDO = sQ + kTile * (D + 1);
  float* sPT = sDO + kTile * (D + 1);
  float* sDST = sPT + kTile * (kTile + 1);
  float* sLse = sDST + kTile * (kTile + 1);
  float* sDelta = sLse + kTile;

  const int k_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int kr = tid / kSub;
  const int sub = tid % kSub;
  const int k_row = k_tile * kTile + kr;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const size_t head_rows = static_cast<size_t>(bh) * t_len;

  stage_tile<D>(sK, k + head, k_tile * kTile, t_len, tid);
  stage_tile<D>(sV, v + head, k_tile * kTile, t_len, tid);

  // Query tiles from the diagonal (the tile holding row k_start) to the
  // last tile with a valid row; none for a tile of padded keys.
  const int first = causal ? k_tile : 0;
  int last = (valid_len + kTile - 1) / kTile;
  if (k_tile * kTile >= valid_len) last = first;

  float acc_k[D / kSub], acc_v[D / kSub];
#pragma unroll
  for (int c = 0; c < D / kSub; ++c) { acc_k[c] = 0.f; acc_v[c] = 0.f; }

  for (int qt = first; qt < last; ++qt) {
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are consumed
    stage_tile<D>(sQ, q + head, qt * kTile, t_len, tid);
    stage_tile<D>(sDO, dout + head, qt * kTile, t_len, tid);
    if (tid < kTile) {
      const int row = qt * kTile + tid;
      const bool ok = row < valid_len;
      sLse[tid] = ok ? lse[head_rows + row] : 0.f;
      sDelta[tid] = ok ? delta[head_rows + row] : 0.f;
    }
    __syncthreads();

    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int m = 0; m < kColsPerThread; ++m) { s[m] = 0.f; dp[m] = 0.f; }
    const float* k_r = sK + kr * (D + 1);
    const float* v_r = sV + kr * (D + 1);
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float kd = k_r[dd];
      const float vd = v_r[dd];
#pragma unroll
      for (int m = 0; m < kColsPerThread; ++m) {
        const int i = sub + kSub * m;
        s[m] = fmaf(sQ[i * (D + 1) + dd], kd, s[m]);
        dp[m] = fmaf(sDO[i * (D + 1) + dd], vd, dp[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kColsPerThread; ++m) {
      const int i = sub + kSub * m;
      const bool ok = entry_valid(qt * kTile + i, k_row, valid_len, causal);
      const float p = ok ? expf(s[m] * scale - sLse[i]) : 0.f;
      sPT[kr * (kTile + 1) + i] = p;
      sDST[kr * (kTile + 1) + i] = p * (dp[m] - sDelta[i]) * scale;
    }
    __syncthreads();

    const float* p_r = sPT + kr * (kTile + 1);
    const float* ds_r = sDST + kr * (kTile + 1);
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      const float p = p_r[i];
      const float ds = ds_r[i];
      const float* do_i = sDO + i * (D + 1) + sub;
      const float* q_i = sQ + i * (D + 1) + sub;
#pragma unroll
      for (int c = 0; c < D / kSub; ++c) {
        acc_v[c] = fmaf(p, do_i[kSub * c], acc_v[c]);
        acc_k[c] = fmaf(ds, q_i[kSub * c], acc_k[c]);
      }
    }
  }

  if (k_row < t_len) {
    float* dk_r = dk + head + static_cast<size_t>(k_row) * D + sub;
    float* dv_r = dv + head + static_cast<size_t>(k_row) * D + sub;
#pragma unroll
    for (int c = 0; c < D / kSub; ++c) {
      dk_r[kSub * c] = acc_k[c];
      dv_r[kSub * c] = acc_v[c];
    }
  }
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const void* lse; const void* delta;
  void* out0; void* out1;  // dq (dQ kernel) or dk, dv (dK/dV kernel)
  int bh, t_len, valid_len, causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq_f32(const Args& a) {
  constexpr size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid((a.t_len + kTile - 1) / kTile, a.bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), a.t_len, a.valid_len, a.causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a) {
  constexpr size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid((a.t_len + kTile - 1) / kTile, a.bh);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.t_len, a.valid_len,
      a.causal, scale);
  return cudaGetLastError();
}

// -- bf16: tensor cores -------------------------------------------------------------

namespace tc {

using namespace t2r_hopper;

constexpr int kQRows = 64;   // query rows per streamed Q/dO tile (dK/dV)
constexpr int kStages = 2;   // ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Two consumer warpgroups of 64 queries each; at D 128 one, so that its dQ
// accumulator (64 floats) beside S and dP fits a thread's registers.
template <int D>
struct DqConfig {
  static constexpr int kDP = D < 64 ? 64 : D;  // head_dim as computed
  static constexpr int kHalves = kDP / 64;
  static constexpr int kConsumers = kDP == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kConsumers;  // query rows per CTA
  static constexpr int kKeys = 64;               // keys per streamed K/V tile
  static constexpr int kThreads = 128 * kConsumers + 32;  // + producer warp
  static constexpr int kHalfQ = kRows * 128;     // bytes of one 64-column half
  static constexpr int kHalfK = kKeys * 128;
  static constexpr int kTileQ = kHalves * kHalfQ;
  static constexpr int kTileK = kHalves * kHalfK;
  static constexpr size_t kSmem = 1024 + 2 * kTileQ + 2 * kStages * kTileK + 64;
};

// dQ for one (BH, query tile). Warpgroup wg owns queries row_base ..
// row_base+63; this thread holds rows row_base + r + 8i and, of each 8-key
// group j of a streamed tile, keys 8j + c2 and 8j + c2 + 1.
template <int D>
__global__ void __launch_bounds__(DqConfig<D>::kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int t_len,
                       int valid_len, int causal, float scale,
                       float scale_log2) {
  using C = DqConfig<D>;
  constexpr int DP = C::kDP;
  constexpr int kKeys = C::kKeys;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = smem;
  uint8_t* s_do = s_q + C::kTileQ;
  uint8_t* s_k = s_do + C::kTileQ;                 // [stage] tiles
  uint8_t* s_v = s_k + kStages * C::kTileK;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(s_v + kStages * C::kTileK);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int m0 = q_tile * C::kRows;
  // Key tiles holding a valid key, up to the diagonal when causal; none
  // for a tile of padded rows (dQ = 0).
  int n_tiles = (valid_len + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (m0 + C::kRows - 1) / kKeys + 1);
  if (m0 >= valid_len) n_tiles = 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * C::kConsumers) {  // producer warp: one thread issues TMA
    if (tid == 128 * C::kConsumers && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, 2 * C::kTileQ);
      for (int h = 0; h < C::kHalves; ++h) {
        tma_load_3d(s_q + h * C::kHalfQ, &map_q, bar_q, 64 * h, m0, bh);
        tma_load_3d(s_do + h * C::kHalfQ, &map_do, bar_q, 64 * h, m0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * C::kTileK);
        for (int h = 0; h < C::kHalves; ++h) {
          const int off = stage * C::kTileK + h * C::kHalfK;
          tma_load_3d(s_k + off, &map_k, &full[stage], 64 * h, it * kKeys, bh);
          tma_load_3d(s_v + off, &map_v, &full[stage], 64 * h, it * kKeys, bh);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r = ((tid % 128) / 32) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int row_base = m0 + wg * 64;

  // lse (to the log2 domain) and delta of this thread's two rows; 0 on
  // padded rows, whose entries are masked.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_base + r + 8 * i;
    const bool ok = row < valid_len;
    const size_t at = static_cast<size_t>(bh) * t_len + row;
    lse_r[i] = ok ? lse[at] * kLog2e : 0.f;
    delta_r[i] = ok ? delta[at] : 0.f;
  }

  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

  // A operands: this warpgroup's 64 rows of the resident Q and dO tiles.
  const uint32_t q_addr = smem_u32(s_q) + wg * 64 * 128;
  const uint32_t do_addr = smem_u32(s_do) + wg * 64 * 128;
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const int n0 = it * kKeys;
    // A causal tile past this warpgroup's last row adds nothing to its dQ.
    if (!(causal && n0 > row_base + 63)) {
      const uint32_t k_addr = smem_u32(s_k) + stage * C::kTileK;
      const uint32_t v_addr = smem_u32(s_v) + stage * C::kTileK;

      // S = Q.K^T and dP = dO.V^T, [64 queries x 64 keys]; all K-major.
      float s[kKeys / 2], dp[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DP / 16; ++k) {
        const int off = (k / 4) * C::kHalfK + (k % 4) * 32;
        const int off_q = (k / 4) * C::kHalfQ + (k % 4) * 32;
        wgmma_ss(s, desc_kmajor(q_addr + off_q), desc_kmajor(k_addr + off), k > 0);
        wgmma_ss(dp, desc_kmajor(do_addr + off_q), desc_kmajor(v_addr + off), k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp(S * scale - lse), masked entries 0 before the exponential
      // (padded rows carry lse = 0); dS = P * (dP - delta) * scale.
      const bool need_mask = n0 + kKeys > valid_len || row_base + 64 > valid_len ||
                             (causal && n0 + kKeys - 1 > row_base);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            bool ok = true;
            if (need_mask) {
              const int key = n0 + 8 * j + c2 + c;
              const int row = row_base + r + 8 * i;
              ok = row < valid_len && key < valid_len && (!causal || key <= row);
            }
            const int idx = 4 * j + 2 * i + c;
            const float p = ok ? exp2f(fmaf(s[idx], scale_log2, -lse_r[i])) : 0.f;
            dp[idx] = p * (dp[idx] - delta_r[i]) * scale;
          }
        }
      }

      // dQ += (dS_hi + dS_lo).K, K read MN-major.
      uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];
      acc_to_frag_split<kKeys>(dp, hi, lo);
      fence_frags(hi);
      fence_frags(lo);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t b = desc_mnmajor(k_addr + kk * 16 * 128, C::kHalfK);
        wgmma_rs_tb(dq_acc, hi[kk], b);
        wgmma_rs_tb(dq_acc, lo[kk], b);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_frags(hi);
      fence_frags(lo);
      fence_regs(dq_acc);
    }
    if (tid % 128 == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_base + r + 8 * i;
    if (row >= t_len) continue;
    __nv_bfloat16* dq_row = dq + (static_cast<size_t>(bh) * t_len + row) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * j) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * i], dq_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  using C = DqConfig<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t err;
  if ((err = encode_bhtd(&map_q, a.q, a.bh, a.t_len, D, C::kRows, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_k, a.k, a.bh, a.t_len, D, C::kKeys, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_v, a.v, a.bh, a.t_len, D, C::kKeys, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_do, a.dout, a.bh, a.t_len, D, C::kRows, 2)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(a.bh, (a.t_len + C::kRows - 1) / C::kRows);
  flash_bwd_dq_tc_kernel<D><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      a.t_len, a.valid_len, a.causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

// Two consumer warpgroups of 64 keys each; at D 128 one, so that its dK
// and dV accumulators (64 floats each) fit a thread's registers.
template <int D>
struct DkvConfig {
  static constexpr int kDP = D < 64 ? 64 : D;  // head_dim as computed
  static constexpr int kHalves = kDP / 64;
  static constexpr int kConsumers = kDP == 128 ? 1 : 2;
  static constexpr int kKeys = 64 * kConsumers;
  static constexpr int kThreads = 128 * kConsumers + 32;  // + producer warp
  static constexpr int kHalfK = kKeys * 128;    // bytes of one 64-column half
  static constexpr int kHalfQ = kQRows * 128;
  static constexpr int kTileK = kHalves * kHalfK;
  static constexpr int kTileQ = kHalves * kHalfQ;
  static constexpr size_t kSmem = 1024 + 2 * kTileK + 2 * kStages * kTileQ
                                  + 2 * kStages * kQRows * 4 + 64;
};

// dK and dV for one (BH, key tile). Warpgroup wg owns keys kw0 .. kw0+63;
// this thread holds keys kw0 + r + 8i and, of each 8-query group j of a
// streamed tile, queries 8j + c2 and 8j + c2 + 1.
template <int D>
__global__ void __launch_bounds__(DkvConfig<D>::kThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int t_len,
                        int valid_len, int causal, float scale,
                        float scale_log2) {
  using C = DkvConfig<D>;
  constexpr int DP = C::kDP;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_k = smem;
  uint8_t* s_v = s_k + C::kTileK;
  uint8_t* s_q = s_v + C::kTileK;                  // [stage] tiles
  uint8_t* s_do = s_q + kStages * C::kTileQ;
  float* s_lse = reinterpret_cast<float*>(s_do + kStages * C::kTileQ);
  float* s_delta = s_lse + kStages * kQRows;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(s_delta + kStages * kQRows);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * C::kKeys;  // causal: tile 0 is the longest
  // Query tiles from the one holding row n0 (causal) to the last with a
  // valid row; none for a tile of padded keys (dK = dV = 0).
  const int first = causal ? n0 / kQRows : 0;
  const int last = n0 >= valid_len ? first : (valid_len + kQRows - 1) / kQRows;
  const int n_iters = last - first;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * C::kConsumers) {  // producer warp
    const int lane = tid % 32;
    if (n_iters == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::kTileK);
      for (int h = 0; h < C::kHalves; ++h) {
        for (int c = 0; c < C::kConsumers; ++c) {
          const int off = h * C::kHalfK + c * 64 * 128;
          tma_load_3d(s_k + off, &map_k, bar_kv, 64 * h, n0 + 64 * c, bh);
          tma_load_3d(s_v + off, &map_v, bar_kv, 64 * h, n0 + 64 * c, bh);
        }
      }
    }
    const size_t rows = static_cast<size_t>(bh) * t_len;
    for (int it = 0; it < n_iters; ++it) {
      const int stage = it % kStages;
      const int q0 = (first + it) * kQRows;
      mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
      // lse (to the log2 domain) and delta of the tile's rows; 0 on
      // padded rows, whose entries are masked.
      for (int rr = lane; rr < kQRows; rr += 32) {
        const int row = q0 + rr;
        const bool ok = row < valid_len;
        s_lse[stage * kQRows + rr] = ok ? lse[rows + row] * kLog2e : 0.f;
        s_delta[stage * kQRows + rr] = ok ? delta[rows + row] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * C::kTileQ);
        for (int h = 0; h < C::kHalves; ++h) {
          const int off = stage * C::kTileQ + h * C::kHalfQ;
          tma_load_3d(s_q + off, &map_q, &full[stage], 64 * h, q0, bh);
          tma_load_3d(s_do + off, &map_do, &full[stage], 64 * h, q0, bh);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r = ((tid % 128) / 32) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int kw0 = n0 + wg * 64;

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) { dk_acc[i] = 0.f; dv_acc[i] = 0.f; }

  // A operands: this warpgroup's 64 rows of the resident K and V tiles.
  const uint32_t k_addr = smem_u32(s_k) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(s_v) + wg * 64 * 128;
  if (n_iters > 0) mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_iters; ++it) {
    const int stage = it % kStages;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const int q0 = (first + it) * kQRows;
    const uint32_t q_addr = smem_u32(s_q) + stage * C::kTileQ;
    const uint32_t do_addr = smem_u32(s_do) + stage * C::kTileQ;
    const float* lse_t = s_lse + stage * kQRows;
    const float* delta_t = s_delta + stage * kQRows;

    // S^T = K.Q^T, [64 keys x 64 queries]; both operands K-major.
    float st[kQRows / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DP / 16; ++k) {
      const int off = (k % 4) * 32;
      wgmma_ss(st, desc_kmajor(k_addr + (k / 4) * C::kHalfK + off),
               desc_kmajor(q_addr + (k / 4) * C::kHalfQ + off), k > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);

    // P^T = exp(S^T * scale - lse[query]); masked entries are 0 before the
    // exponential (padded rows carry lse = 0).
    const bool need_mask = q0 + kQRows > valid_len || kw0 + 64 > valid_len ||
                           (causal && q0 < kw0 + 63);
#pragma unroll
    for (int j = 0; j < kQRows / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + c2 + c;
          bool ok = true;
          if (need_mask) {
            const int key = kw0 + r + 8 * i;
            const int q_pos = q0 + col;
            ok = q_pos < valid_len && key < valid_len && (!causal || key <= q_pos);
          }
          const int idx = 4 * j + 2 * i + c;
          st[idx] = ok ? exp2f(fmaf(st[idx], scale_log2, -lse_t[col])) : 0.f;
        }
      }
    }

    // dV += P^T.dO as (P_hi + P_lo).dO, and dP^T = V.dO^T; dO is read
    // MN-major for the first and K-major for the second.
    uint32_t hi[kQRows / 16][4], lo[kQRows / 16][4];
    acc_to_frag_split<kQRows>(st, hi, lo);
    float dpt[kQRows / 2];
    fence_frags(hi);
    fence_frags(lo);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint64_t b = desc_mnmajor(do_addr + kk * 16 * 128, C::kHalfQ);
      wgmma_rs_tb(dv_acc, hi[kk], b);
      wgmma_rs_tb(dv_acc, lo[kk], b);
    }
#pragma unroll
    for (int k = 0; k < DP / 16; ++k) {
      const int off = (k % 4) * 32;
      wgmma_ss(dpt, desc_kmajor(v_addr + (k / 4) * C::kHalfK + off),
               desc_kmajor(do_addr + (k / 4) * C::kHalfQ + off), k > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(hi);
    fence_frags(lo);
    fence_regs(dv_acc);
    fence_regs(dpt);

    // dS^T = P^T * (dP^T - delta[query]) * scale, then dK += dS^T.Q as
    // (dS_hi + dS_lo).Q, Q read MN-major.
#pragma unroll
    for (int j = 0; j < kQRows / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * i + c;
          dpt[idx] = st[idx] * (dpt[idx] - delta_t[8 * j + c2 + c]) * scale;
        }
      }
    }
    acc_to_frag_split<kQRows>(dpt, hi, lo);
    fence_frags(hi);
    fence_frags(lo);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint64_t b = desc_mnmajor(q_addr + kk * 16 * 128, C::kHalfQ);
      wgmma_rs_tb(dk_acc, hi[kk], b);
      wgmma_rs_tb(dk_acc, lo[kk], b);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(hi);
    fence_frags(lo);
    fence_regs(dk_acc);
    if (tid % 128 == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw0 + r + 8 * i;
    if (key >= t_len) continue;
    const size_t base = (static_cast<size_t>(bh) * t_len + key) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  using C = DkvConfig<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t err;
  if ((err = encode_bhtd(&map_q, a.q, a.bh, a.t_len, D, kQRows, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_k, a.k, a.bh, a.t_len, D, 64, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_v, a.v, a.bh, a.t_len, D, 64, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_do, a.dout, a.bh, a.t_len, D, kQRows, 2)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(a.bh, (a.t_len + C::kKeys - 1) / C::kKeys);
  flash_bwd_dkv_tc_kernel<D><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.t_len, a.valid_len, a.causal,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

// The tensor-core kernels (bf16) or the CUDA-core ones (f32).
template <bool kDq, int D>
cudaError_t launch_dtype(const Args& a, int dtype) {
  if (dtype == 0) return kDq ? launch_dq_f32<D>(a) : launch_dkv_f32<D>(a);
  if (dtype == 1) return kDq ? launch_dq<D>(a) : launch_dkv<D>(a);
  return cudaErrorInvalidValue;
}

}  // namespace tc

template <bool kDq>
int dispatch(const Args& a, int head_dim, int dtype) {
  if (a.bh <= 0 || a.bh > 65535 || a.t_len <= 0 || a.valid_len <= 0 ||
      a.valid_len > a.t_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (head_dim) {
    case 16: err = tc::launch_dtype<kDq, 16>(a, dtype); break;
    case 32: err = tc::launch_dtype<kDq, 32>(a, dtype); break;
    case 64: err = tc::launch_dtype<kDq, 64>(a, dtype); break;
    case 128: err = tc::launch_dtype<kDq, 128>(a, dtype); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// q, k, v, dout, dq: [BH, T, D] of one dtype (0 = float32, 1 = bfloat16);
// lse, delta: f32 [BH, T]. Returns a cudaError_t.
extern "C" int t2r_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh,
                                int t_len, int head_dim, int valid_len,
                                int causal, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, t_len, valid_len, causal,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim, dtype);
}

// As t2r_flash_bwd_dq, writing dk and dv [BH, T, D].
extern "C" int t2r_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh,
                                 int t_len, int head_dim, int valid_len,
                                 int causal, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, bh, t_len, valid_len, causal,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim, dtype);
}

extern "C" const char* t2r_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

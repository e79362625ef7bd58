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
// (S, dP, dV, dK) of 2*BH*T^2*D/2 = 17.2 GFLOP each, on ~45 MB of operands
// (bf16). In f32 every product is three TF32 products (below): 155 and 206
// GFLOP of TF32, 0.31 and 0.42 ms at the 495 TFLOP/s peak.
//
// Both dtypes run on the tensor cores: a producer warp issues TMA loads
// (3-D maps, so a tile never reads past its head) of the kernel's own
// block once and of the streamed operand through a ring of full/empty
// mbarriers; consumer warpgroups of 64 rows run the products as `wgmma`.
// Score accumulators are the A-operand registers of the next product, so
// P and dS never go through shared memory; each tile's contribution to
// dQ, dK or dV is summed in f32.
//
// * bf16. Two consumer warpgroups (one at D 128, where the accumulators
//   take 64 or 128 registers a thread), a 2-stage ring. The two score
//   products run from shared memory (SS), K-major as stored; the next
//   product's B operand is a resident or streamed tile read MN-major
//   through a second descriptor of the same buffer. A bf16 product rounds
//   its A operand, and rounding P or dS once moves dQ, dK and dV 18-33x
//   further from the f32 function than the split does
//   (tests/test_torch_flash_numerics.py); so each is split into bf16 hi +
//   lo (about 16 mantissa bits) and fed as two products. head_dim 16 and 32
//   are computed at 64 (TMA fills the missing columns with zeros).
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
// * f32: 3xTF32 on `wgmma` m64nNk8 `.tf32`. Every f32 operand x is split
//   into big = tf32(x) and small = tf32(x - big) (round to nearest, 13 low
//   bits clear), and each product is small.big + big.small + big.big in
//   f32. big + small holds x to ~2^-22 relative and the dropped small.small
//   term is ~2^-22 of the product, so dQ, dK and dV keep the f32 limit
//   (1e-4 of max(1, max|ref|)) that one TF32 product (2^-11) misses
//   (tests/test_torch_flash_numerics.py emulates both). The tensor cores'
//   f32 accumulation truncates, so each tile's product goes into a fresh
//   accumulator that is added to dQ, dK or dV on the CUDA cores (the f32
//   forward measured the chained form 17x further off).
//   - The split pass (`flash_bwd_split_kernel`), once per backward, before
//     both kernels: it writes the big and small planes of Q, K, V and dO
//     ([BH, T, DP], DP = max(D, 32) columns, zero-filled) and of the
//     transposes Q^T, dO^T and K^T ([BH, DP, T8], T8 = T rounded up to 8).
//     `.tf32` takes only K-major operands, and dK += dS^T.Q, dV += P^T.dO
//     and dQ += dS.K contract over queries or keys, so their B operands are
//     those transposes. In them the queries (keys) of each group of 8 are
//     stored in the order 0 2 4 6 1 3 5 7 (`perm8`): the score
//     accumulator's registers are then the tf32 A fragment as they stand.
//     The main kernels only TMA-load ready tiles: no split, no transpose,
//     no named barrier and no proxy fence between generic writes and
//     `wgmma` inside them, and a Q/dO tile that up to T/64 dK/dV CTAs read
//     is split once. It moves ~300 MB at the training shape (0.09 ms at
//     3.35 TB/s).
//   - dQ (`flash_bwd_dq_tc_split_kernel`): one CTA per (BH, 128-query tile;
//     64 at D 128), longest causal tiles first; Q and dO big and small
//     resident (128 KB); tiles of 32 keys (K, V and K^T, big and small: 48
//     KB at D 64, 96 KB at D 128) through a 2-stage ring (1 stage at D 128).
//     S and dP by m64n32k8 SS, dS split in registers, dQ += dS.K (B: K^T)
//     by RS in chunks of 64 columns. Shared memory 225 KB at D 64 and D
//     128; 168 registers a thread at D 64 (the cap of two warpgroups).
//   - dK/dV (`flash_bwd_dkv_tc_split_kernel`): one CTA of one consumer
//     warpgroup per (BH, 64-key tile): K and V big and small resident; Q,
//     dO, Q^T and dO^T tiles of 32 queries (16 at D 128, whose transposes
//     are 64-byte rows with 64B swizzle) with their lse and delta through a
//     2-stage ring (1 stage at D 128). S^T = K.Q^T and dP^T = V.dO^T by
//     m64nNk8 SS, then dV += P^T.dO (B: dO^T) and dK += dS^T.Q (B: Q^T) by
//     RS. Shared memory 194 KB at D 64 and D 128. A thread holds the dK
//     and dV accumulators, the scores and the split fragments (235
//     registers at D 64), which is why it runs one warpgroup.
//   head_dim 16 is computed at 32 (the planes carry zero columns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_common.cuh"

namespace {

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const void* lse; const void* delta;
  const void* rows; const void* cols;  // f32: the split pass's planes
  void* out0; void* out1;  // dq (dQ kernel) or dk, dv (dK/dV kernel)
  int bh, t_len, valid_len, causal;
  cudaStream_t stream;
};

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

// -- f32: 3xTF32 ------------------------------------------------------------------

// The split pass's planes, each a tf32 big or small part: `rows` holds
// [kRowPlanes, BH, T, DP], `cols` the transposes [kColPlanes, BH, DP, T8]
// with the T index permuted by `perm8`. A 3-D tensor map over [planes *
// BH, rows, columns] reaches plane p of head bh at coordinate p * BH + bh.
enum RowPlane { kQb, kQs, kKb, kKs, kVb, kVs, kDOb, kDOs, kRowPlanes };
enum ColPlane { kQTb, kQTs, kDOTb, kDOTs, kKTb, kKTs, kColPlanes };

constexpr int kSplitRows = 32;     // rows (transposed: columns) per block
constexpr int kSplitThreads = 256;

// Rows t0..t0+31 of one [BH, T, d] operand of head bh: big and small parts
// to the row planes `big` and `small` ([BH, T, DP]), 16 bytes a thread;
// with kTranspose also through the padded shared tile (stride DP + 1:
// conflict-free both ways) to the transposed planes `t_big` and `t_small`
// ([BH, DP, T8]), 32 permuted positions per row, coalesced. Rows at or
// past t_len and columns at or past d are 0.
template <int DP, bool kTranspose>
__device__ __forceinline__ void split_rows(
    const float* __restrict__ src, float* __restrict__ big,
    float* __restrict__ small, float* __restrict__ t_big,
    float* __restrict__ t_small, float (*tile)[DP + 1], int bh, int t0,
    int t_len, int d, int t8) {
  const int tid = threadIdx.x;
  static_assert(kSplitRows * DP % (4 * kSplitThreads) == 0, "whole passes");
#pragma unroll
  for (int pass = 0; pass < kSplitRows * DP / (4 * kSplitThreads); ++pass) {
    const int i = tid + pass * kSplitThreads;
    const int r = i / (DP / 4), c = 4 * (i % (DP / 4));
    const int t = t0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < t_len && c < d)
      x = *reinterpret_cast<const float4*>(src + (static_cast<size_t>(bh) * t_len + t) * d + c);
    if (kTranspose) {
      tile[r][c] = x.x;
      tile[r][c + 1] = x.y;
      tile[r][c + 2] = x.z;
      tile[r][c + 3] = x.w;
    }
    if (t < t_len) {
      uint4 b, sm;
      split_tf32(x.x, b.x, sm.x);
      split_tf32(x.y, b.y, sm.y);
      split_tf32(x.z, b.z, sm.z);
      split_tf32(x.w, b.w, sm.w);
      const size_t at = (static_cast<size_t>(bh) * t_len + t) * DP + c;
      *reinterpret_cast<uint4*>(big + at) = b;
      *reinterpret_cast<uint4*>(small + at) = sm;
    }
  }
  if (!kTranspose) return;
  __syncthreads();
#pragma unroll
  for (int pass = 0; pass < kSplitRows * DP / kSplitThreads; ++pass) {
    const int i = tid + pass * kSplitThreads;
    const int c = i / kSplitRows, p = i % kSplitRows;
    if (t0 + p >= t8) continue;
    uint32_t b, sm;
    split_tf32(tile[unperm8(p)][c], b, sm);
    const size_t at = (static_cast<size_t>(bh) * DP + c) * t8 + t0 + p;
    t_big[at] = __uint_as_float(b);
    t_small[at] = __uint_as_float(sm);
  }
  __syncthreads();  // the tile is consumed
}

// One block per (32-row tile, BH): the row planes of Q, K, V and dO, and
// the transposed planes of Q, dO and K.
template <int DP>
__global__ void __launch_bounds__(kSplitThreads)
flash_bwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       float* __restrict__ rows, float* __restrict__ cols,
                       int t_len, int d, int t8) {
  __shared__ float tile[kSplitRows][DP + 1];
  const int t0 = blockIdx.x * kSplitRows;
  const int bh = blockIdx.y;
  const size_t rp = static_cast<size_t>(gridDim.y) * t_len * DP;  // one plane
  const size_t cp = static_cast<size_t>(gridDim.y) * DP * t8;
  split_rows<DP, true>(q, rows + kQb * rp, rows + kQs * rp, cols + kQTb * cp,
                       cols + kQTs * cp, tile, bh, t0, t_len, d, t8);
  split_rows<DP, true>(k, rows + kKb * rp, rows + kKs * rp, cols + kKTb * cp,
                       cols + kKTs * cp, tile, bh, t0, t_len, d, t8);
  split_rows<DP, false>(v, rows + kVb * rp, rows + kVs * rp, nullptr, nullptr,
                        tile, bh, t0, t_len, d, t8);
  split_rows<DP, true>(dout, rows + kDOb * rp, rows + kDOs * rp,
                       cols + kDOTb * cp, cols + kDOTs * cp, tile, bh, t0,
                       t_len, d, t8);
}

template <int DP>
cudaError_t launch_split_dp(const void* q, const void* k, const void* v,
                            const void* dout, void* rows, void* cols, int bh,
                            int t_len, int d, cudaStream_t stream) {
  const int t8 = (t_len + 7) / 8 * 8;
  dim3 grid((t_len + kSplitRows - 1) / kSplitRows, bh);
  flash_bwd_split_kernel<DP><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(rows), static_cast<float*>(cols), t_len, d, t8);
  return cudaGetLastError();
}

// A^T-side product of the backward: out[DP/2] += A.B, where A is the f32
// accumulator of a [64 x K] score product (K = keys or queries, in the
// permuted order of B) and B a transposed tile, DP rows (the output
// columns) of K values, big at `b_big`, small at `b_small`, rows of
// kRowBytes. A is split in registers into tf32 fragments; each chunk of NC
// output columns is small.big + big.small + big.big into a fresh
// accumulator, added to `out` on the CUDA cores.
template <int K, int DP, int NC, int kRowBytes>
__device__ __forceinline__ void add_split_product(float (&out)[DP / 2],
                                                  const float (&a)[K / 2],
                                                  uint32_t b_big,
                                                  uint32_t b_small) {
  uint32_t a_big[K / 8][4], a_small[K / 8][4];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(a[4 * kk + 2 * (e % 2) + e / 2], a_big[kk][e], a_small[kk][e]);
  }
#pragma unroll
  for (int nc = 0; nc < DP / NC; ++nc) {
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    fence_frags(a_big);
    fence_frags(a_small);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      const uint32_t off = nc * NC * kRowBytes + kk * 32;
      const uint64_t bb = desc_kmajor_rows<kRowBytes>(b_big + off);
      wgmma_tf32_rs(acc, a_small[kk], bb);
      wgmma_tf32_rs(acc, a_big[kk], desc_kmajor_rows<kRowBytes>(b_small + off));
      wgmma_tf32_rs(acc, a_big[kk], bb);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(a_big);
    fence_frags(a_small);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) out[nc * NC / 2 + i] += acc[i];
  }
}

// Two consumer warpgroups of 64 queries (one at D 128, with a 1-stage
// ring: shared memory 225 KB either way).
template <int D>
struct DqSplitConfig {
  static constexpr int kDP = D < 32 ? 32 : D;       // head_dim as computed
  static constexpr int kBlocks = kDP / 32;          // 32-float column blocks
  static constexpr int kConsumers = kDP == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kConsumers;     // query rows per CTA
  static constexpr int kKeys = 32;                  // keys per streamed tile
  static constexpr int kStages = kDP == 128 ? 1 : 2;
  static constexpr int kNC = kDP < 64 ? kDP : 64;   // dQ columns per product
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kThreads = kConsumerThreads + 32;  // + producer warp
  static constexpr int kBlockQ = kRows * 128;       // bytes of one column block
  static constexpr int kBlockK = kKeys * 128;
  static constexpr int kTileQ = kBlocks * kBlockQ;  // one plane's tile
  static constexpr int kTileK = kBlocks * kBlockK;
  static constexpr int kTileKT = kDP * 128;         // kDP rows of 32 keys
  // A stage: K, V big and small; K^T big and small.
  static constexpr int kStage = 4 * kTileK + 2 * kTileKT;
  static constexpr size_t kSmem = 1024 + 4 * static_cast<size_t>(kTileQ)
                                  + kStages * static_cast<size_t>(kStage) + 64;
};

// dQ for one (BH, query tile). Warpgroup wg owns queries row_base ..
// row_base+63; this thread holds rows row_base + r + 8i and, of each 8-key
// group j of a streamed tile, keys 8j + c2 and 8j + c2 + 1.
template <int D>
__global__ void __launch_bounds__(DqSplitConfig<D>::kThreads, 1)
flash_bwd_dq_tc_split_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_kt,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int t_len, int valid_len,
                             int causal, float scale, float scale_log2) {
  using C = DqSplitConfig<D>;
  constexpr int DP = C::kDP;
  constexpr int kKeys = C::kKeys;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = smem;                           // Q b, Q s, dO b, dO s
  uint8_t* s_ring = s_q + 4 * C::kTileQ;         // [stage] K b/s, V b/s, K^T b/s
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(s_ring + C::kStages * C::kStage);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + C::kStages;

  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
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
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= C::kConsumerThreads) {  // producer warp: one thread issues TMA
    if (tid == C::kConsumerThreads && n_tiles > 0) {
      const int q_planes[4] = {kQb, kQs, kDOb, kDOs};
      mbar_arrive_expect_tx(bar_q, 4 * C::kTileQ);
      for (int p = 0; p < 4; ++p) {
        for (int h = 0; h < C::kBlocks; ++h)
          tma_load_3d(s_q + p * C::kTileQ + h * C::kBlockQ, &map_q, bar_q,
                      32 * h, m0, q_planes[p] * n_bh + bh);
      }
      const int k_planes[4] = {kKb, kKs, kVb, kVs};
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % C::kStages;
        uint8_t* st = s_ring + stage * C::kStage;
        mbar_wait(&empty[stage], ((it / C::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], C::kStage);
        for (int p = 0; p < 4; ++p) {
          for (int h = 0; h < C::kBlocks; ++h)
            tma_load_3d(st + p * C::kTileK + h * C::kBlockK, &map_k,
                        &full[stage], 32 * h, it * kKeys, k_planes[p] * n_bh + bh);
        }
        for (int p = 0; p < 2; ++p)
          tma_load_3d(st + 4 * C::kTileK + p * C::kTileKT, &map_kt, &full[stage],
                      it * kKeys, 0, (kKTb + p) * n_bh + bh);
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

  // This warpgroup's 64 rows of the resident planes (plane p at + p * kTileQ).
  const uint32_t q_addr = smem_u32(s_q) + wg * 64 * 128;
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % C::kStages;
    mbar_wait(&full[stage], (it / C::kStages) & 1);
    const int n0 = it * kKeys;
    // A causal tile past this warpgroup's last row adds nothing to its dQ.
    if (!(causal && n0 > row_base + 63)) {
      const uint32_t st = smem_u32(s_ring) + stage * C::kStage;

      // S = Q.K^T and dP = dO.V^T, [64 queries x 32 keys], each
      // small.big + big.small + big.big; all K-major.
      float s[kKeys / 2], dp[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DP / 8; ++k) {
        const int off_q = (k / 4) * C::kBlockQ + (k % 4) * 32;
        const int off_k = (k / 4) * C::kBlockK + (k % 4) * 32;
        const uint64_t qb = desc_kmajor(q_addr + 0 * C::kTileQ + off_q);
        const uint64_t kb = desc_kmajor(st + 0 * C::kTileK + off_k);
        wgmma_tf32_ss(s, desc_kmajor(q_addr + 1 * C::kTileQ + off_q), kb, k > 0);
        wgmma_tf32_ss(s, qb, desc_kmajor(st + 1 * C::kTileK + off_k), 1);
        wgmma_tf32_ss(s, qb, kb, 1);
        const uint64_t dob = desc_kmajor(q_addr + 2 * C::kTileQ + off_q);
        const uint64_t vb = desc_kmajor(st + 2 * C::kTileK + off_k);
        wgmma_tf32_ss(dp, desc_kmajor(q_addr + 3 * C::kTileQ + off_q), vb, k > 0);
        wgmma_tf32_ss(dp, dob, desc_kmajor(st + 3 * C::kTileK + off_k), 1);
        wgmma_tf32_ss(dp, dob, vb, 1);
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

      // dQ += dS.K with K^T (DP rows of the tile's 32 permuted keys) as B.
      const uint32_t kt = st + 4 * C::kTileK;
      add_split_product<kKeys, DP, C::kNC, 128>(dq_acc, dp, kt, kt + C::kTileKT);
    }
    if (tid % 128 == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_base + r + 8 * i;
    if (row >= t_len) continue;
    float* dq_row = dq + (static_cast<size_t>(bh) * t_len + row) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dq_row + 8 * j) =
          make_float2(dq_acc[4 * j + 2 * i], dq_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_split(const Args& a) {
  using C = DqSplitConfig<D>;
  constexpr int DP = C::kDP;
  if (a.rows == nullptr || a.cols == nullptr) return cudaErrorInvalidValue;
  const int t8 = (a.t_len + 7) / 8 * 8;
  CUtensorMap map_q, map_k, map_kt;
  cudaError_t err;
  if ((err = encode_bhtd(&map_q, a.rows, kRowPlanes * a.bh, a.t_len, DP, C::kRows, 4)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_k, a.rows, kRowPlanes * a.bh, a.t_len, DP, C::kKeys, 4)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_kt, a.cols, kColPlanes * a.bh, DP, t8, DP, 4)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_split_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(a.bh, (a.t_len + C::kRows - 1) / C::kRows);
  flash_bwd_dq_tc_split_kernel<D><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      map_q, map_k, map_kt, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.out0), a.t_len,
      a.valid_len, a.causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

// One consumer warpgroup of 64 keys. At D 128 the streamed tiles hold 16
// queries (their transposes are 64-byte rows, 64B-swizzled) and the ring
// one stage: shared memory 193 KB at D 64 and D 128.
template <int D>
struct DkvSplitConfig {
  static constexpr int kDP = D < 32 ? 32 : D;       // head_dim as computed
  static constexpr int kBlocks = kDP / 32;          // 32-float column blocks
  static constexpr int kKeys = 64;                  // keys per CTA
  static constexpr int kQ = kDP == 128 ? 16 : 32;   // queries per streamed tile
  static constexpr int kStages = kDP == 128 ? 1 : 2;
  static constexpr int kTRowBytes = kQ * 4;         // rows of a transposed tile
  static constexpr int kNC = kDP < 64 ? kDP : 64;   // dK/dV columns per product
  static constexpr int kThreads = 128 + 32;         // + producer warp
  static constexpr int kBlockK = kKeys * 128;       // bytes of one column block
  static constexpr int kBlockQ = kQ * 128;
  static constexpr int kTileK = kBlocks * kBlockK;  // one plane's tile
  static constexpr int kTileQ = kBlocks * kBlockQ;
  static constexpr int kTileQT = kDP * kTRowBytes;
  // A stage: Q, dO big and small; Q^T, dO^T big and small.
  static constexpr int kStage = 4 * kTileQ + 4 * kTileQT;
  static constexpr size_t kSmem = 1024 + 4 * static_cast<size_t>(kTileK)
                                  + kStages * static_cast<size_t>(kStage)
                                  + 2 * kStages * kQ * 4 + 64;
};

// dK and dV for one (BH, 64-key tile). This thread holds keys n0 + r + 8i
// and, of each 8-query group j of a streamed tile, queries 8j + c2 and
// 8j + c2 + 1.
template <int D>
__global__ void __launch_bounds__(DkvSplitConfig<D>::kThreads, 1)
flash_bwd_dkv_tc_split_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_qt,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int t_len, int valid_len, int causal, float scale,
                              float scale_log2) {
  using C = DkvSplitConfig<D>;
  constexpr int DP = C::kDP;
  constexpr int kQ = C::kQ;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_k = smem;                             // K b, K s, V b, V s
  uint8_t* s_ring = s_k + 4 * C::kTileK;           // [stage] Q, dO, Q^T, dO^T b/s
  float* s_lse = reinterpret_cast<float*>(s_ring + C::kStages * C::kStage);
  float* s_delta = s_lse + C::kStages * kQ;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(s_delta + C::kStages * kQ);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + C::kStages;

  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
  const int n0 = blockIdx.y * C::kKeys;  // causal: tile 0 is the longest
  // Query tiles from the one holding row n0 (causal) to the last with a
  // valid row; none for a tile of padded keys (dK = dV = 0).
  const int first = causal ? n0 / kQ : 0;
  const int last = n0 >= valid_len ? first : (valid_len + kQ - 1) / kQ;
  const int n_iters = last - first;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp
    const int lane = tid % 32;
    if (n_iters == 0) return;
    if (lane == 0) {
      const int k_planes[4] = {kKb, kKs, kVb, kVs};
      mbar_arrive_expect_tx(bar_kv, 4 * C::kTileK);
      for (int p = 0; p < 4; ++p) {
        for (int h = 0; h < C::kBlocks; ++h)
          tma_load_3d(s_k + p * C::kTileK + h * C::kBlockK, &map_k, bar_kv,
                      32 * h, n0, k_planes[p] * n_bh + bh);
      }
    }
    const int q_planes[4] = {kQb, kQs, kDOb, kDOs};
    const size_t rows = static_cast<size_t>(bh) * t_len;
    for (int it = 0; it < n_iters; ++it) {
      const int stage = it % C::kStages;
      const int q0 = (first + it) * kQ;
      mbar_wait(&empty[stage], ((it / C::kStages) & 1) ^ 1);
      // lse (to the log2 domain) and delta of the tile's rows; 0 on
      // padded rows, whose entries are masked.
      for (int rr = lane; rr < kQ; rr += 32) {
        const int row = q0 + rr;
        const bool ok = row < valid_len;
        s_lse[stage * kQ + rr] = ok ? lse[rows + row] * kLog2e : 0.f;
        s_delta[stage * kQ + rr] = ok ? delta[rows + row] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        uint8_t* st = s_ring + stage * C::kStage;
        mbar_arrive_expect_tx(&full[stage], C::kStage);
        for (int p = 0; p < 4; ++p) {
          for (int h = 0; h < C::kBlocks; ++h)
            tma_load_3d(st + p * C::kTileQ + h * C::kBlockQ, &map_q, &full[stage],
                        32 * h, q0, q_planes[p] * n_bh + bh);
        }
        for (int p = 0; p < 4; ++p)  // Q^T b, Q^T s, dO^T b, dO^T s
          tma_load_3d(st + 4 * C::kTileQ + p * C::kTileQT, &map_qt, &full[stage],
                      q0, 0, (kQTb + p) * n_bh + bh);
      }
    }
    return;
  }

  const int lane = tid % 32;
  const int r = (tid / 32) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) { dk_acc[i] = 0.f; dv_acc[i] = 0.f; }

  // The resident planes (plane p at + p * kTileK): the A operands.
  const uint32_t k_addr = smem_u32(s_k);
  if (n_iters > 0) mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_iters; ++it) {
    const int stage = it % C::kStages;
    mbar_wait(&full[stage], (it / C::kStages) & 1);
    const int q0 = (first + it) * kQ;
    const uint32_t st = smem_u32(s_ring) + stage * C::kStage;
    const float* lse_t = s_lse + stage * kQ;
    const float* delta_t = s_delta + stage * kQ;

    // S^T = K.Q^T and dP^T = V.dO^T, [64 keys x kQ queries], each
    // small.big + big.small + big.big; all K-major.
    float s[kQ / 2], dp[kQ / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DP / 8; ++k) {
      const int off_k = (k / 4) * C::kBlockK + (k % 4) * 32;
      const int off_q = (k / 4) * C::kBlockQ + (k % 4) * 32;
      const uint64_t kb = desc_kmajor(k_addr + 0 * C::kTileK + off_k);
      const uint64_t qb = desc_kmajor(st + 0 * C::kTileQ + off_q);
      wgmma_tf32_ss(s, desc_kmajor(k_addr + 1 * C::kTileK + off_k), qb, k > 0);
      wgmma_tf32_ss(s, kb, desc_kmajor(st + 1 * C::kTileQ + off_q), 1);
      wgmma_tf32_ss(s, kb, qb, 1);
      const uint64_t vb = desc_kmajor(k_addr + 2 * C::kTileK + off_k);
      const uint64_t dob = desc_kmajor(st + 2 * C::kTileQ + off_q);
      wgmma_tf32_ss(dp, desc_kmajor(k_addr + 3 * C::kTileK + off_k), dob, k > 0);
      wgmma_tf32_ss(dp, vb, desc_kmajor(st + 3 * C::kTileQ + off_q), 1);
      wgmma_tf32_ss(dp, vb, dob, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T * scale - lse[query]), masked entries 0 before the
    // exponential (padded rows carry lse = 0); dS^T = P^T * (dP^T -
    // delta[query]) * scale.
    const bool need_mask = q0 + kQ > valid_len || n0 + 64 > valid_len ||
                           (causal && q0 < n0 + 63);
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + c2 + c;
          bool ok = true;
          if (need_mask) {
            const int key = n0 + r + 8 * i;
            const int q_pos = q0 + col;
            ok = q_pos < valid_len && key < valid_len && (!causal || key <= q_pos);
          }
          const int idx = 4 * j + 2 * i + c;
          const float p = ok ? exp2f(fmaf(s[idx], scale_log2, -lse_t[col])) : 0.f;
          s[idx] = p;
          dp[idx] = p * (dp[idx] - delta_t[col]) * scale;
        }
      }
    }

    // dV += P^T.dO and dK += dS^T.Q, with dO^T and Q^T (DP rows of the
    // tile's kQ permuted queries) as B.
    const uint32_t qt = st + 4 * C::kTileQ;
    add_split_product<kQ, DP, C::kNC, C::kTRowBytes>(
        dv_acc, s, qt + kDOTb * C::kTileQT, qt + kDOTs * C::kTileQT);
    add_split_product<kQ, DP, C::kNC, C::kTRowBytes>(
        dk_acc, dp, qt + kQTb * C::kTileQT, qt + kQTs * C::kTileQT);
    if (tid == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = n0 + r + 8 * i;
    if (key >= t_len) continue;
    const size_t base = (static_cast<size_t>(bh) * t_len + key) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + base + 8 * j) =
          make_float2(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
      *reinterpret_cast<float2*>(dv + base + 8 * j) =
          make_float2(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_split(const Args& a) {
  using C = DkvSplitConfig<D>;
  constexpr int DP = C::kDP;
  if (a.rows == nullptr || a.cols == nullptr) return cudaErrorInvalidValue;
  const int t8 = (a.t_len + 7) / 8 * 8;
  CUtensorMap map_q, map_k, map_qt;
  cudaError_t err;
  if ((err = encode_bhtd(&map_q, a.rows, kRowPlanes * a.bh, a.t_len, DP, C::kQ, 4)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_k, a.rows, kRowPlanes * a.bh, a.t_len, DP, C::kKeys, 4)) != cudaSuccess) return err;
  if ((err = encode_bhtd_box(&map_qt, a.cols, kColPlanes * a.bh, DP, t8, DP, 4,
                             C::kTRowBytes)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_split_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(a.bh, (a.t_len + C::kKeys - 1) / C::kKeys);
  flash_bwd_dkv_tc_split_kernel<D><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      map_q, map_k, map_qt, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.t_len, a.valid_len, a.causal, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

// dtype 0 (f32): the 3xTF32 kernels on the split pass's planes; 1 (bf16):
// the bf16 ones.
template <bool kDq, int D>
cudaError_t launch_dtype(const Args& a, int dtype) {
  if (dtype == 0) return kDq ? launch_dq_split<D>(a) : launch_dkv_split<D>(a);
  if (dtype == 1) return kDq ? launch_dq<D>(a) : launch_dkv<D>(a);
  return cudaErrorInvalidValue;
}

cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* dout, void* rows, void* cols, int bh,
                         int t_len, int d, cudaStream_t s) {
  switch (d) {
    case 16:
    case 32: return launch_split_dp<32>(q, k, v, dout, rows, cols, bh, t_len, d, s);
    case 64: return launch_split_dp<64>(q, k, v, dout, rows, cols, bh, t_len, d, s);
    case 128: return launch_split_dp<128>(q, k, v, dout, rows, cols, bh, t_len, d, s);
    default: return cudaErrorInvalidValue;
  }
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

// The split pass of the f32 backward: q, k, v, dout f32 [BH, T, D]; rows
// f32 [8, BH, T, DP] and cols f32 [6, BH, DP, T8] (DP = max(D, 32), T8 = T
// rounded up to 8), written whole. Returns a cudaError_t.
extern "C" int t2r_flash_bwd_split(const void* q, const void* k, const void* v,
                                   const void* dout, void* rows, void* cols,
                                   int bh, int t_len, int head_dim,
                                   void* stream) {
  if (bh <= 0 || bh > 65535 || t_len <= 0 || rows == nullptr || cols == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const pointers[6] = {q, k, v, dout, rows, cols};
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)  // float4 loads and stores
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(tc::launch_split(q, k, v, dout, rows, cols, bh, t_len,
                                           head_dim,
                                           static_cast<cudaStream_t>(stream)));
}

// q, k, v, dout, dq: [BH, T, D] of one dtype (0 = float32, 1 = bfloat16);
// lse, delta: f32 [BH, T]; rows, cols: for f32 the split pass's planes of
// these q, k, v, dout (which the f32 kernels read instead of them), for
// bf16 unused. Returns a cudaError_t.
extern "C" int t2r_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* rows,
                                const void* cols, void* dq, int bh, int t_len,
                                int head_dim, int valid_len, int causal,
                                int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, rows, cols, dq, nullptr, bh, t_len,
         valid_len, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim, dtype);
}

// As t2r_flash_bwd_dq, writing dk and dv [BH, T, D].
extern "C" int t2r_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* rows,
                                 const void* cols, void* dk, void* dv, int bh,
                                 int t_len, int head_dim, int valid_len,
                                 int causal, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, rows, cols, dk, dv, bh, t_len, valid_len,
         causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim, dtype);
}

extern "C" const char* t2r_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

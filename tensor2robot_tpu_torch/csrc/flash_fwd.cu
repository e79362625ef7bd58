// Flash attention forward for Hopper (sm_90a).
//
// Replaces: tensor2robot_tpu/ops/attention.py `_flash_fwd_kernel` (launched
// by `_flash_forward`), the Pallas TPU kernel behind
// `flash_attention`, used by the stateless predict of the causal sequence
// policy and by every train step with attention_backend='flash'.
//
// What it computes, per (batch*head, query row): softmax attention over the
// keys, with the causal triangle and the key/row padding mask of
// `valid_len` (the wrapper pads a T that does not tile). Outputs O [BH, T, D]
// in the input dtype and the row logsumexp lse [BH, T] in f32; padded rows
// (row >= valid_len) get O = 0 and lse = 0. Masked keys are skipped, not
// scored at finfo.min/2: for every real row at least one key is unmasked
// (the diagonal when causal, key 0 otherwise), where exp(finfo.min/2 - m)
// is exactly 0 in f32, so the two agree. For bf16 inputs P is rounded to
// bf16 before the PV product, as the TPU kernel does.
//
// What bounds it on an H100: operations. At the train step's shape
// (B*H = 16, T = 4096, D = 64, causal) it does 4*BH*T^2*D/2 = 34 GFLOP on
// 34 MB, about 1000 flop per byte.
//
// Two designs, chosen by dtype inside `t2r_flash_fwd`:
//
// * bf16: tensor cores (`flash_fwd_tc_kernel`). One CTA per (BH, 128-row
//   query tile), longest causal tiles first; two consumer warpgroups own
//   64 query rows each, one producer warp issues TMA loads: Q once, then
//   K and V tiles of 128 keys through a 2-stage ring of full/empty
//   mbarriers. S = Q.K^T is `wgmma` m64n128k16 with both operands in
//   shared memory (K-major as stored); the online softmax runs on the
//   accumulator fragment (row max and sum across the quad by shuffles, O
//   rescaled in registers); P, rounded to bf16 in registers, is the A
//   operand of O += P.V (`wgmma` RS, V read MN-major through the
//   descriptor). Only tiles that cross the diagonal, valid_len or the
//   padded rows run the mask. head_dim 16 and 32 are computed at 64 (TMA
//   fills the missing columns with zeros). Shared memory: 80 KB at D <= 64,
//   160 KB at D 128.
// * f32: the f32 CUDA cores (`flash_fwd_kernel`), exact f32 products, which
//   the f32 parity limit (1e-4) needs: TF32 tensor cores keep 10 mantissa
//   bits. One thread block (256 threads) per (batch*head, 64-row query
//   tile), four threads per query row. K/V tiles of 64 keys are staged in
//   shared memory as f32; each thread scores 16 keys of its row, the four
//   threads of a row combine their maxima and sums by warp shuffles (online
//   softmax, f32), and each thread accumulates D/4 output columns. The
//   causal loop stops at the diagonal tile, and at the last tile holding a
//   valid key. It is limited by shared-memory reads, about one per FMA.
//
// The TPU's sequential k-block grid axis becomes the in-block loop over
// key tiles in both designs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_common.cuh"

namespace {

// -- f32: CUDA cores ------------------------------------------------------------

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per staged tile
constexpr int kSub = 4;       // threads per query row
constexpr int kThreads = kBlockM * kSub;
constexpr int kKeysPerThread = kBlockN / kSub;

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBlockM) * (D + 1)      // Q
         + static_cast<size_t>(kBlockN) * (D + 1)    // K
         + static_cast<size_t>(kBlockN) * D          // V
         + static_cast<size_t>(kBlockM) * (kBlockN + 1);  // P
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t_len, int valid_len,
                 int causal, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockM * (D + 1);
  float* sV = sK + kBlockN * (D + 1);
  float* sP = sV + kBlockN * D;

  const int q_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / kSub;      // query row within the tile
  const int sub = tid % kSub;
  const int q_row = q_tile * kBlockM + r;
  const size_t head_base = static_cast<size_t>(bh) * t_len * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int row = q_tile * kBlockM + rr;
    sQ[rr * (D + 1) + dd] =
        row < t_len ? q[head_base + static_cast<size_t>(row) * D + dd] : 0.f;
  }

  int num_tiles = (valid_len + kBlockN - 1) / kBlockN;
  if (causal) num_tiles = min(num_tiles, q_tile + 1);
  const bool row_valid = q_row < valid_len;

  float m = -INFINITY;
  float l = 0.f;
  float acc[D / kSub];
#pragma unroll
  for (int c = 0; c < D / kSub; ++c) acc[c] = 0.f;

  for (int kt = 0; kt < num_tiles; ++kt) {
    __syncthreads();  // previous tile's P and V are consumed
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int jj = i / D, dd = i % D;
      const int key = kt * kBlockN + jj;
      const size_t off = head_base + static_cast<size_t>(key) * D + dd;
      const bool in = key < t_len;
      sK[jj * (D + 1) + dd] = in ? k[off] : 0.f;
      sV[jj * D + dd] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.f;
    const float* q_r = sQ + r * (D + 1);
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float qd = q_r[dd];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        s[i] = fmaf(qd, sK[(sub + kSub * i) * (D + 1) + dd], s[i]);
      }
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int key = kt * kBlockN + sub + kSub * i;
      const bool ok = row_valid && key < valid_len && (!causal || key <= q_row);
      s[i] = ok ? s[i] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    // A row with no valid key yet keeps m = -inf, l = 0 and P = 0.
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = __expf(m - m_use);
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = __expf(s[i] - m_use);
      p_sum += p;
      sP[r * (kBlockN + 1) + sub + kSub * i] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = l * alpha + p_sum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int c = 0; c < D / kSub; ++c) acc[c] *= alpha;
    const float* p_r = sP + r * (kBlockN + 1);
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      const float p = p_r[j];
      const float* v_j = sV + j * D + sub;
#pragma unroll
      for (int c = 0; c < D / kSub; ++c) acc[c] = fmaf(p, v_j[kSub * c], acc[c]);
    }
  }

  if (q_row < t_len) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* o_r = o + head_base + static_cast<size_t>(q_row) * D + sub;
#pragma unroll
    for (int c = 0; c < D / kSub; ++c) o_r[kSub * c] = acc[c] * inv;
    if (sub == 0) {
      lse[static_cast<size_t>(bh) * t_len + q_row] =
          row_valid ? m + logf(fmaxf(l, 1e-30f)) : 0.f;
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_len, int valid_len, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid((t_len + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), t_len, valid_len, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32_dim(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int t_len, int d,
                           int valid_len, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_f32<16>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 32: return launch_f32<32>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 64: return launch_f32<64>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 128: return launch_f32<128>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16: tensor cores --------------------------------------------------------

namespace tc {

using namespace t2r_hopper;

constexpr int kRows = 128;   // query rows per CTA: 64 per consumer warpgroup
constexpr int kKeys = 128;   // keys per K/V tile
constexpr int kStages = 2;   // K/V ring depth
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 32;  // + one producer warp
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory bytes of one stored tile: `rows` rows in 64-column halves.
template <int D>
constexpr int tile_bytes(int rows) {
  return (D < 64 ? 1 : D / 64) * rows * 128;
}
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + tile_bytes<D>(kRows) + 2 * kStages * tile_bytes<D>(kKeys) + 64;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int t_len, int valid_len, int causal, float scale_log2) {
  constexpr int DP = D < 64 ? 64 : D;   // head_dim as computed
  constexpr int kHalves = DP / 64;
  constexpr int kHalfQ = kRows * 128;   // bytes of one 64-column half
  constexpr int kHalfKV = kKeys * 128;
  constexpr int kTileKV = kHalves * kHalfKV;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = smem;
  uint8_t* s_k = s_q + kHalves * kHalfQ;
  uint8_t* s_v = s_k + kStages * kTileKV;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(s_v + kStages * kTileKV);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int m0 = q_tile * kRows;
  int n_tiles = (valid_len + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (m0 + kRows - 1) / kKeys + 1);
  if (m0 >= valid_len) n_tiles = 0;  // padded rows only: O = 0, lse = 0

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // producer warp: one thread issues TMA
    if (tid == kConsumerThreads && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, kHalves * kHalfQ);
      for (int h = 0; h < kHalves; ++h)
        tma_load_3d(s_q + h * kHalfQ, &map_q, bar_q, 64 * h, m0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * kTileKV);
        for (int h = 0; h < kHalves; ++h) {
          tma_load_3d(s_k + stage * kTileKV + h * kHalfKV, &map_k, &full[stage],
                      64 * h, it * kKeys, bh);
          tma_load_3d(s_v + stage * kTileKV + h * kHalfKV, &map_v, &full[stage],
                      64 * h, it * kKeys, bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroup `wg`: query rows row_base .. row_base + 63. This
  // thread holds rows row_base + r + 8i (i = 0, 1) and, of each 8-column
  // group j, columns 8j + c2 and 8j + c2 + 1.
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r = ((tid % 128) / 32) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int row_base = m0 + wg * 64;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's partial row sums

  const uint32_t q_addr = smem_u32(s_q) + wg * 64 * 128;
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const uint32_t k_addr = smem_u32(s_k) + stage * kTileKV;
    const uint32_t v_addr = smem_u32(s_v) + stage * kTileKV;

    // S = Q.K^T, [64 rows x 128 keys].
    float s[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DP / 16; ++k) {
      const int off = (k % 4) * 32;
      wgmma_ss(s, desc_kmajor(q_addr + (k / 4) * kHalfQ + off),
               desc_kmajor(k_addr + (k / 4) * kHalfKV + off), k > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Scale to the log2 domain and mask where the tile needs it.
    const int n0 = it * kKeys;
    const bool need_mask = n0 + kKeys > valid_len || row_base + 64 > valid_len ||
                           (causal && n0 + kKeys - 1 > row_base);
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale_log2;
          if (need_mask) {
            const int key = n0 + 8 * j + c2 + c;
            const int row = row_base + r + 8 * i;
            const bool ok = row < valid_len && key < valid_len &&
                            (!causal || key <= row);
            x = ok ? x : -INFINITY;
          }
          s[4 * j + 2 * i + c] = x;
          tile_max[i] = fmaxf(tile_max[i], x);
        }
      }
    }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
      const float m_new = fmaxf(m_row[i], tile_max[i]);
      // A row with no valid key yet keeps m = -inf, l = 0 and P = 0.
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_row[i] - m_use[i]);
      m_row[i] = m_new;
      l_row[i] *= alpha;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 2 * i] *= alpha;
        acc[4 * j + 2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[4 * j + 2 * i + c] - m_use[i]);
          s[4 * j + 2 * i + c] = p;
          l_row[i] += p;
        }
      }
    }

    // O += P.V with P rounded to bf16 in registers; V MN-major.
    uint32_t p_frag[kKeys / 16][4];
    acc_to_frag<kKeys>(s, p_frag);
    fence_frags(p_frag);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs_tb(acc, p_frag[kk], desc_mnmajor(v_addr + kk * 16 * 128, kHalfKV));
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(p_frag);
    fence_regs(acc);
    if (tid % 128 == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_base + r + 8 * i;
    if (row >= t_len) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* o_row = o + (static_cast<size_t>(bh) * t_len + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j + c2) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    }
    if (lane % 4 == 0) {
      lse[static_cast<size_t>(bh) * t_len + row] =
          row < valid_len ? (m_row[i] + log2f(fmaxf(l, 1e-30f))) * kLn2 : 0.f;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t_len, int valid_len, int causal,
                   cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err;
  if ((err = encode_bhtd(&map_q, q, bh, t_len, D, kRows)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_k, k, bh, t_len, D, kKeys)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_v, v, bh, t_len, D, kKeys)) != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  dim3 grid(bh, (t_len + kRows - 1) / kRows);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), t_len, valid_len, causal, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_len, int d, int valid_len,
                       int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 32: return launch<32>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 64: return launch<64>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 128: return launch<128>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int t2r_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int t_len,
                             int head_dim, int valid_len, int causal,
                             int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || t_len <= 0 || valid_len <= 0 ||
      valid_len > t_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32_dim(q, k, v, o, lse, bh, t_len, head_dim, valid_len, causal, s);
  } else if (dtype == 1) {
    err = tc::launch_dim(q, k, v, o, lse, bh, t_len, head_dim, valid_len, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* t2r_flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

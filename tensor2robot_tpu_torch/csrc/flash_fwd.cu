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
// 34 MB, about 1000 flop per byte; in f32, 3xTF32 triples the tensor-core
// work.
//
// Both dtypes run on the tensor cores with one structure: one CTA per (BH,
// query tile), longest causal tiles first; consumer warpgroups own 64
// query rows each, one producer warp issues TMA loads (3-D maps, so a tile
// never reads past its head): Q once, then K and V tiles through a 2-stage
// ring of full/empty mbarriers. S = Q.K^T is `wgmma` with both operands in
// shared memory, K-major as stored; the online softmax runs on the
// accumulator fragment (row max and sum across the quad by shuffles, O
// rescaled in registers); P is the register A operand of O += P.V. Only
// tiles that cross the diagonal, valid_len or the padded rows run the mask.
// The TPU's sequential k-block grid axis becomes the loop over key tiles.
//
// * bf16 (`flash_fwd_tc_kernel`): 128 query rows (two warpgroups), K/V
//   tiles of 128 keys, `wgmma` m64n128k16; P rounded to bf16 in registers,
//   V read MN-major through the descriptor. head_dim 16 and 32 are
//   computed at 64 (TMA fills the missing columns with zeros). Shared
//   memory: 80 KB at D <= 64, 160 KB at D 128.
// * f32 (`flash_fwd_tc_split_kernel`): 3xTF32. Every f32 operand x is split
//   into big = tf32(x) and small = tf32(x - big), and each product is
//   small.big + big.small + big.big in f32 (`wgmma` m64nNk8 .tf32), about
//   2^-22 relative: the f32 limit (1e-4) holds where one TF32 product
//   (2^-11) does not (tests/test_torch_flash_numerics.py). K/V tiles of 64
//   keys arrive as raw f32; the consumers split Q once (big in place, small
//   beside it) and each K tile the same way, behind a named barrier. `.tf32`
//   takes only K-major operands, so the same pass writes V^T big and small
//   tiles ([D, keys], keys contiguous). In them the keys of each group of 8
//   are permuted (0 2 4 6 1 3 5 7): P's accumulator fragment holds columns
//   2c and 2c+1 of each 8, the tf32 A fragment wants c and c+4, and with
//   the permutation P's registers are the A fragment as they stand. P stays
//   f32 up to its split. Each tile's P.V is summed into O on the CUDA
//   cores, not chained through the tensor cores' truncating accumulator.
//   Two warpgroups (128 rows) at D <= 64, one at D 128
//   with a 1-stage ring (shared memory: 177 KB at D 64, 225 KB at D 128);
//   head_dim 16 is computed at 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_common.cuh"

namespace {

// -- bf16 ----------------------------------------------------------------------

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
  if ((err = encode_bhtd(&map_q, q, bh, t_len, D, kRows, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_k, k, bh, t_len, D, kKeys, 2)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_v, v, bh, t_len, D, kKeys, 2)) != cudaSuccess) return err;
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

// -- f32: 3xTF32 ------------------------------------------------------------------

template <int D>
struct SplitConfig {
  static constexpr int kDP = D < 32 ? 32 : D;     // head_dim as computed
  static constexpr int kBlocks = kDP / 32;        // 32-float column blocks
  static constexpr int kConsumers = kDP == 128 ? 1 : 2;
  static constexpr int kRows = 64 * kConsumers;   // query rows per CTA
  static constexpr int kKeys = 64;                // keys per K/V tile
  static constexpr int kStages = kDP == 128 ? 1 : 2;
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kThreads = kConsumerThreads + 32;  // + producer warp
  static constexpr int kBlockQ = kRows * 128;     // bytes of one column block
  static constexpr int kBlockKV = kKeys * 128;
  static constexpr int kTileQ = kBlocks * kBlockQ;
  static constexpr int kTileKV = kBlocks * kBlockKV;
  static constexpr int kBlockVt = kDP * 128;      // 32 keys of V^T, kDP rows
  // Q (big in place) and Q small; the K and V ring; K small, V^T big and
  // V^T small of the current tile (each kTileKV bytes); the barriers.
  static constexpr size_t kSmem = 1024 + 2 * kTileQ + 2 * kStages * kTileKV
                                  + 3 * kTileKV + 64;
};

template <int D>
__global__ void __launch_bounds__(SplitConfig<D>::kThreads, 1)
flash_fwd_tc_split_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          float* __restrict__ o, float* __restrict__ lse,
                          int t_len, int valid_len, int causal,
                          float scale_log2) {
  using C = SplitConfig<D>;
  constexpr int DP = C::kDP;
  constexpr int kKeys = C::kKeys;
  constexpr int NC = C::kConsumerThreads;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = smem;                              // Q, then its big part
  uint8_t* s_qs = s_q + C::kTileQ;                  // Q small
  uint8_t* s_k = s_qs + C::kTileQ;                  // [stage] K, then big
  uint8_t* s_v = s_k + C::kStages * C::kTileKV;     // [stage] V as loaded
  uint8_t* s_ks = s_v + C::kStages * C::kTileKV;    // K small
  uint8_t* s_vt = s_ks + C::kTileKV;                // V^T big
  uint8_t* s_vts = s_vt + C::kTileKV;               // V^T small
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(s_vts + C::kTileKV);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + C::kStages;

  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int m0 = q_tile * C::kRows;
  int n_tiles = (valid_len + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (m0 + C::kRows - 1) / kKeys + 1);
  if (m0 >= valid_len) n_tiles = 0;  // padded rows only: O = 0, lse = 0

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

  if (tid >= NC) {  // producer warp: one thread issues TMA
    if (tid == NC && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, C::kTileQ);
      for (int h = 0; h < C::kBlocks; ++h)
        tma_load_3d(s_q + h * C::kBlockQ, &map_q, bar_q, 32 * h, m0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % C::kStages;
        mbar_wait(&empty[stage], ((it / C::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * C::kTileKV);
        for (int h = 0; h < C::kBlocks; ++h) {
          const int off = stage * C::kTileKV + h * C::kBlockKV;
          tma_load_3d(s_k + off, &map_k, &full[stage], 32 * h, it * kKeys, bh);
          tma_load_3d(s_v + off, &map_v, &full[stage], 32 * h, it * kKeys, bh);
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

  if (n_tiles > 0) {
    // This warpgroup's 64 rows of Q: big in place, small beside it. The
    // fence and barrier of the first tile publish them to wgmma.
    mbar_wait(bar_q, 0);
    for (int h = 0; h < C::kBlocks; ++h) {
      const int base = h * C::kBlockQ + wg * 64 * 128;
      for (int i = tid % 128; i < 64 * 128 / 16; i += 128)
        split4_in_place(s_q + base + 16 * i, s_qs + base + 16 * i);
    }
  }
  const uint32_t q_addr = smem_u32(s_q) + wg * 64 * 128;
  const uint32_t qs_addr = smem_u32(s_qs) + wg * 64 * 128;
  const uint32_t ks_addr = smem_u32(s_ks);
  const uint32_t vt_addr = smem_u32(s_vt);
  const uint32_t vts_addr = smem_u32(s_vts);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % C::kStages;
    mbar_wait(&full[stage], (it / C::kStages) & 1);
    uint8_t* k_t = s_k + stage * C::kTileKV;
    const uint8_t* v_t = s_v + stage * C::kTileKV;

    // Every consumer is done with the previous tile's K small and V^T.
    consumer_sync(NC);
    // K: big in place, small at the same swizzled offsets.
    for (int i = tid; i < C::kTileKV / 16; i += NC)
      split4_in_place(k_t + 16 * i, s_ks + 16 * i);
    // V^T big and small: row d, keys in 32-key column blocks, key j of
    // each group of 8 at position (j >> 1) + 4 (j & 1). A warp takes 32
    // keys of four columns: its reads and writes hit distinct banks.
    for (int i = tid; i < kKeys * DP / 4; i += NC) {
      const int key = i % kKeys;
      const int d0 = (i / kKeys) * 4;
      const float4 x = *reinterpret_cast<const float4*>(
          v_t + (d0 / 32) * C::kBlockKV + swz128_f32(key, d0 % 32));
      const int kp = perm8(key);
      const int block = (kp / 32) * C::kBlockVt;
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t big, small;
        split_tf32(xs[e], big, small);
        const int off = block + swz128_f32(d0 + e, kp % 32);
        *reinterpret_cast<uint32_t*>(s_vt + off) = big;
        *reinterpret_cast<uint32_t*>(s_vts + off) = small;
      }
    }
    fence_proxy_async();
    consumer_sync(NC);

    const int n0 = it * kKeys;
    // A causal tile past this warpgroup's last row: nothing to score.
    if (causal && n0 > row_base + 63) {
      if (tid % 128 == 0) mbar_arrive(&empty[stage]);
      continue;
    }

    // S = Q.K^T, [64 rows x 64 keys]: small.big + big.small + big.big.
    const uint32_t k_addr = smem_u32(k_t);
    float s[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DP / 8; ++k) {
      const int off = (k % 4) * 32;
      const uint64_t qb = desc_kmajor(q_addr + (k / 4) * C::kBlockQ + off);
      const uint64_t kb = desc_kmajor(k_addr + (k / 4) * C::kBlockKV + off);
      wgmma_tf32_ss_m64n64(
          s, desc_kmajor(qs_addr + (k / 4) * C::kBlockQ + off), kb, k > 0);
      wgmma_tf32_ss_m64n64(
          s, qb, desc_kmajor(ks_addr + (k / 4) * C::kBlockKV + off), 1);
      wgmma_tf32_ss_m64n64(s, qb, kb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    // K and V of this stage are consumed (V lives on in V^T).
    if (tid % 128 == 0) mbar_arrive(&empty[stage]);

    // Scale to the log2 domain and mask where the tile needs it.
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

    // O += P.V: the tile's product by wgmma into a fresh accumulator, added
    // to O on the CUDA cores. The tensor cores' f32 accumulation truncates:
    // chained through every key tile (up to 1536 products at T 4096) it
    // moved O by 2.9e-5 relative to the plain version on the card; summed
    // per tile, 1.7e-6.
    float pv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) pv[i] = 0.f;
#pragma unroll
    for (int h = 0; h < kKeys / 32; ++h) {
      // P = exp2(S - m) for keys 32h .. 32h+31, f32, split into tf32 A
      // fragments: fragment kk takes keys 8kk .. 8kk+7 in V^T's permuted
      // order, so a[0..3] are the accumulator's (row, 2c), (row+8, 2c),
      // (row, 2c+1), (row+8, 2c+1).
      uint32_t pb[4][4], ps[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = a % 2, c = a / 2;
          const float p = exp2f(s[4 * (4 * h + kk) + 2 * i + c] - m_use[i]);
          l_row[i] += p;
          split_tf32(p, pb[kk][a], ps[kk][a]);
        }
      }
      // P.V^T as small.big + big.small + big.big.
      fence_frags(pb);
      fence_frags(ps);
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = h * C::kBlockVt + kk * 32;
        const uint64_t vb = desc_kmajor(vt_addr + off);
        wgmma_tf32_rs(pv, ps[kk], vb);
        wgmma_tf32_rs(pv, pb[kk], desc_kmajor(vts_addr + off));
        wgmma_tf32_rs(pv, pb[kk], vb);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_frags(pb);
      fence_frags(ps);
      fence_regs(pv);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] += pv[i];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_base + r + 8 * i;
    if (row >= t_len) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* o_row = o + (static_cast<size_t>(bh) * t_len + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(o_row + 8 * j + c2) =
          make_float2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    }
    if (lane % 4 == 0) {
      lse[static_cast<size_t>(bh) * t_len + row] =
          row < valid_len ? (m_row[i] + log2f(fmaxf(l, 1e-30f))) * kLn2 : 0.f;
    }
  }
}

template <int D>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int t_len, int valid_len,
                         int causal, cudaStream_t stream) {
  using C = SplitConfig<D>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err;
  if ((err = encode_bhtd(&map_q, q, bh, t_len, D, C::kRows, 4)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_k, k, bh, t_len, D, C::kKeys, 4)) != cudaSuccess) return err;
  if ((err = encode_bhtd(&map_v, v, bh, t_len, D, C::kKeys, 4)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_tc_split_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  dim3 grid(bh, (t_len + C::kRows - 1) / C::kRows);
  flash_fwd_tc_split_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<float*>(o), static_cast<float*>(lse),
      t_len, valid_len, causal, scale_log2);
  return cudaGetLastError();
}

// dtype 0 (f32): the 3xTF32 kernel; 1 (bf16): the bf16 one.
template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, void* o, void* lse, int bh, int t_len,
                         int valid_len, int causal, cudaStream_t s) {
  if (dtype == 0) return launch_split<D>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
  if (dtype == 1) return launch<D>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_dim(int dtype, const void* q, const void* k, const void* v,
                       void* o, void* lse, int bh, int t_len, int d,
                       int valid_len, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dtype<16>(dtype, q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 32: return launch_dtype<32>(dtype, q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 64: return launch_dtype<64>(dtype, q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 128: return launch_dtype<128>(dtype, q, k, v, o, lse, bh, t_len, valid_len, causal, s);
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
  return static_cast<int>(tc::launch_dim(dtype, q, k, v, o, lse, bh, t_len,
                                         head_dim, valid_len, causal,
                                         static_cast<cudaStream_t>(stream)));
}

extern "C" const char* t2r_flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

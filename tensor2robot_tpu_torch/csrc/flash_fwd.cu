// Flash attention forward for Hopper (sm_90a).
//
// Replaces: tensor2robot_tpu/ops/attention.py `_flash_fwd_kernel` (launched
// by `_flash_forward`), the Pallas TPU kernel behind
// `flash_attention`, used by the stateless predict of the causal sequence
// policy with attention_backend='flash'.
//
// What it computes, per (batch*head, query row): softmax attention over the
// keys, with the causal triangle and the key/row padding mask of
// `valid_len` (the wrapper pads a T that does not tile). Outputs O [BH, T, D]
// in the input dtype and the row logsumexp lse [BH, T] in f32; padded rows
// (row >= valid_len) get O = 0 and lse = 0. Masked keys are skipped, not
// scored at finfo.min/2: for every real row at least one key is unmasked
// (the diagonal when causal, key 0 otherwise), where exp(finfo.min/2 - m)
// is exactly 0 in f32, so the two agree.
//
// What bounds it on an H100: operations. At the served shape
// (B*H = 8, T = 4096, D = 64, causal) it does 4*BH*T^2*D/2 = 17 GFLOP on
// 34 MB, about 500 flop per byte. This first version runs the products on
// the f32 CUDA cores (67 TFLOP/s peak), not the tensor cores, and is
// limited by shared-memory reads: about one shared load per FMA.
//
// What the design does about it: one thread block (256 threads) per
// (batch*head, 64-row query tile), four threads per query row. K/V tiles of
// 64 keys are staged in shared memory as f32 (bf16 inputs are widened on
// load); each thread scores 16 keys of its row, the four threads of a row
// combine their maxima and sums by warp shuffles (online softmax, f32), and
// each thread accumulates D/4 output columns. The causal loop stops at the
// diagonal tile, and at the last tile holding a valid key. The TPU's
// sequential k-block grid axis becomes this in-block loop. For bf16 inputs P
// is rounded to bf16 before the PV product, as the TPU kernel does.
// Tensor-core products (mma.sync / wgmma) and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per staged tile
constexpr int kSub = 4;       // threads per query row
constexpr int kThreads = kBlockM * kSub;
constexpr int kKeysPerThread = kBlockN / kSub;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// P as the PV product sees it: the input dtype's rounding of p.
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBlockM) * (D + 1)      // Q
         + static_cast<size_t>(kBlockN) * (D + 1)    // K
         + static_cast<size_t>(kBlockN) * D          // V
         + static_cast<size_t>(kBlockM) * (kBlockN + 1);  // P
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
        row < t_len ? to_f32(q[head_base + static_cast<size_t>(row) * D + dd]) : 0.f;
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
      sK[jj * (D + 1) + dd] = in ? to_f32(k[off]) : 0.f;
      sV[jj * D + dd] = in ? to_f32(v[off]) : 0.f;
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
      sP[r * (kBlockN + 1) + sub + kSub * i] = round_p<T>(p);
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
    T* o_r = o + head_base + static_cast<size_t>(q_row) * D + sub;
#pragma unroll
    for (int c = 0; c < D / kSub; ++c) o_r[kSub * c] = from_f32<T>(acc[c] * inv);
    if (sub == 0) {
      lse[static_cast<size_t>(bh) * t_len + q_row] =
          row_valid ? m + logf(fmaxf(l, 1e-30f)) : 0.f;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t_len, int valid_len, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid((t_len + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t_len, valid_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int t_len, int d, int valid_len,
                         int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t_len, valid_len, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

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
    err = launch_dtype<float>(q, k, v, o, lse, bh, t_len, head_dim, valid_len, causal, s);
  } else if (dtype == 1) {
    err = launch_dtype<__nv_bfloat16>(q, k, v, o, lse, bh, t_len, head_dim, valid_len, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* t2r_flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

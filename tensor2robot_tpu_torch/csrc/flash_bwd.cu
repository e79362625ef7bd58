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
// Inputs are f32 or bf16; bf16 is widened to f32 on load, and P, dP and dS
// stay f32 (the TPU kernels widen dO and keep P/dS in f32; unlike the
// forward, nothing is rounded to bf16 before a product). dQ, dK and dV are
// cast to the input dtype once, at the end. lse and delta are f32 [BH, T].
//
// The FlashAttention-2 split of the TPU package: the dQ kernel is one thread
// block per (BH, 64-row query tile) and loops over key tiles up to the
// diagonal; the dK/dV kernel is one thread block per (BH, 64-key tile) and
// loops over query tiles from the diagonal tile (the tile holding row
// k_start) to the last tile with a valid row. Each output element is
// written by exactly one block: no atomics, deterministic results.
//
// What bounds them on an H100: operations. At the training shape (BH = 16,
// T = 4096, D = 64, causal) dQ does 3 products (S, dP, dQ) and dK/dV 4
// (S, dP, dV, dK) of 2*BH*T^2*D/2 = 17.2 GFLOP each, on ~45 MB of operands.
// This first version runs the products on the f32 CUDA cores (67 TFLOP/s
// peak), not the tensor cores, and like flash_fwd.cu it is limited by
// shared-memory reads (about one per FMA).
//
// What the design does about it: 256 threads, four per tile row. Tiles are
// staged in shared memory as f32 with a padded row stride (D + 1) so the
// four threads of a row and the eight rows of a warp hit distinct banks.
// Each thread scores 16 columns of its row (S and dP together, sharing the
// loop over D), writes P or dS to a shared tile, and after a barrier
// accumulates D/4 output columns in registers. Tensor-core products
// (mma.sync / wgmma), TMA staging and a fused delta are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;                  // rows per tile (queries or keys)
constexpr int kSub = 4;                    // threads per tile row
constexpr int kThreads = kTile * kSub;     // 256
constexpr int kColsPerThread = kTile / kSub;  // 16 scored columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stages rows [row0, row0 + kTile) of a [T, D] head into a shared tile of
// stride D + 1, widened to f32; rows at or past t_len read as 0.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src,
                                           int row0, int t_len, int tid) {
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int row = row0 + rr;
    dst[rr * (D + 1) + dd] =
        row < t_len ? to_f32(src[static_cast<size_t>(row) * D + dd]) : 0.f;
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

// dQ for one (BH, query tile). Thread (r, sub) owns query row r: it scores
// keys sub + 4i of each key tile and accumulates dQ columns sub + 4c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_len, int valid_len, int causal,
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

  stage_tile<T, D>(sQ, q + head, q_tile * kTile, t_len, tid);
  stage_tile<T, D>(sDO, dout + head, q_tile * kTile, t_len, tid);
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
    stage_tile<T, D>(sK, k + head, kt * kTile, t_len, tid);
    stage_tile<T, D>(sV, v + head, kt * kTile, t_len, tid);
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
    T* dq_r = dq + head + static_cast<size_t>(q_row) * D + sub;
#pragma unroll
    for (int c = 0; c < D / kSub; ++c) dq_r[kSub * c] = from_f32<T>(acc[c]);
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * static_cast<size_t>(kTile) * (D + 1)      // K, V, Q, dO
         + 2 * static_cast<size_t>(kTile) * (kTile + 1)  // P^T, dS^T
         + 2 * static_cast<size_t>(kTile);             // lse, delta
}

// dK and dV for one (BH, key tile). Thread (kr, sub) owns key row kr: it
// scores queries sub + 4m of each query tile and accumulates dK and dV
// columns sub + 4c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_len,
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

  stage_tile<T, D>(sK, k + head, k_tile * kTile, t_len, tid);
  stage_tile<T, D>(sV, v + head, k_tile * kTile, t_len, tid);

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
    stage_tile<T, D>(sQ, q + head, qt * kTile, t_len, tid);
    stage_tile<T, D>(sDO, dout + head, qt * kTile, t_len, tid);
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
    T* dk_r = dk + head + static_cast<size_t>(k_row) * D + sub;
    T* dv_r = dv + head + static_cast<size_t>(k_row) * D + sub;
#pragma unroll
    for (int c = 0; c < D / kSub; ++c) {
      dk_r[kSub * c] = from_f32<T>(acc_k[c]);
      dv_r[kSub * c] = from_f32<T>(acc_v[c]);
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

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid((a.t_len + kTile - 1) / kTile, a.bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.t_len, a.valid_len, a.causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid((a.t_len + kTile - 1) / kTile, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.t_len, a.valid_len,
      a.causal, scale);
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int head_dim, int dtype) {
  if (a.bh <= 0 || a.bh > 65535 || a.t_len <= 0 || a.valid_len <= 0 ||
      a.valid_len > a.t_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dim<kDq, float>(a, head_dim);
  } else if (dtype == 1) {
    err = dispatch_dim<kDq, __nv_bfloat16>(a, head_dim);
  } else {
    err = cudaErrorInvalidValue;
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

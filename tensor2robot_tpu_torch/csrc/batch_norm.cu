// Fused batch-norm training forward and backward for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's batch norm (flax
// `nn.BatchNorm`, in `tensor2robot_tpu/research/qtopt/models.py` Grasping44
// and `tensor2robot_tpu/layers/film_resnet.py`) is left to XLA, which fuses
// it. In the port it was plain PyTorch (`layers/flax_layers.py` `moments`
// and `normalize`): about 40 launches a norm, each activation widened to a
// materialised float32 copy and swept a dozen times, forward and backward.
// These kernels compute the same function as `ops/batch_norm.py`
// `_batch_norm_forward_plain` and `_batch_norm_backward_plain`.
//
// What it computes, per channel c of x ([N, C] or [N, C, H, W]) over the
// M = N*H*W values of that channel, all in float32 (flax's
// `_compute_stats` and `_normalize`):
//   forward   mean = E[x], var = max(E[x^2] - mean^2, 0),
//             rstd = rsqrt(var + eps),
//             y = (x - mean) * (rstd * scale) + bias, rounded once to x's
//             dtype; the new running statistics
//             momentum * running + (1 - momentum) * (mean, var), written
//             to new tensors; mean and rstd saved for the backward.
//   backward  x^ = (x - mean) * rstd, dbias = sum(dy), dscale = sum(dy x^),
//             dx = scale * rstd * (dy - sum(dy) / M - x^ * sum(dy x^) / M).
//
// What bounds it on an H100: bytes. The arithmetic is a few operations an
// element. The design reads x four times and dy twice, and writes y and dx
// once each: 16 bytes an element in bf16 (forward 6: two reads of x, one
// write of y; backward 10: two reads of x and of dy, one write of dx),
// where the plain chain moved well over 100.
//
// Design: three launches each way.
//   1. A reduction pass (statistics of x; sum(dy) and sum(dy (x - mean))).
//      Every block sums in float32 registers and writes one partial per
//      channel: partial[2][S][C] for the S blocks along the data.
//   2. A finalise launch, 32 channels a block, sums the S partials in
//      float64 (a tree over float32 per-thread sums: the same quantity as
//      the plain version's, computed more exactly) and computes the
//      per-channel values: mean, rstd and the running statistics forward;
//      dscale, dbias and the coefficients of dx backward.
//   3. An elementwise pass: y, or dx.
// Two layouts, chosen by the wrapper from the strides, each read without a
// copy:
//   * rows: [M, C] with C contiguous (a [N, C] input; channels-last NCHW,
//     what the critic's cuDNN convolutions hand over). `lanes` threads
//     (a power of two up to 32) cover one row's channel groups of V values
//     (a 16-byte vector: 8 bf16 or 4 float32), so a warp reads
//     32 / lanes whole neighbouring rows; grid.y tiles wider rows. A thread
//     keeps its channels' sums, or its per-channel constants, in
//     registers.
//   * planes: [N, C, P] with each (n, c) plane of P = H*W contiguous
//     (NCHW-contiguous). grid.y is the channel; a warp walks one chunk of
//     one plane in 16-byte vectors, with a scalar head up to the first
//     16-byte boundary of the plane and a scalar tail.
// Four loads are in flight per thread in the passes. V = 1 instantiations
// take a row width or a base pointer that does not allow 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kFinalTile = 32;  // channels a finalise block covers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of T, moved as one 16-byte access when V * sizeof(T) == 16.
template <typename T, int V>
struct Pack {
  float v[V];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
    }
  }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V * sizeof(T) == 16) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = from_f32<T>(v[i]);
    }
  }
};

// A per-channel parameter (scale or bias) in float32 or bf16; `fallback`
// where the parameter is absent.
__device__ __forceinline__ float param(const void* p, int bf16, int c,
                                       float fallback) {
  if (p == nullptr) return fallback;
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

__device__ __forceinline__ void store_param(void* p, int bf16, int c,
                                            float v) {
  if (p == nullptr) return;
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[c] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[c] = v;
  }
}

// ---------------------------------------------------------------------------
// Rows layout: x as [M, C], C contiguous.

struct RowLanes {
  int group;  // channel group: channels [group * V, group * V + V)
  long long row0, stride;
};

__device__ __forceinline__ RowLanes row_lanes(int lanes) {
  RowLanes r;
  r.group = blockIdx.y * lanes + (threadIdx.x & (lanes - 1));
  const int rows_per_step = kThreads / lanes;
  r.row0 = static_cast<long long>(blockIdx.x) * rows_per_step +
           threadIdx.x / lanes;
  r.stride = static_cast<long long>(gridDim.x) * rows_per_step;
  return r;
}

// Sums a[] and b[] over the threads of the block that share a channel
// group, and writes the block's partial of each channel: out_a[ch],
// out_b[ch].
template <int V>
__device__ __forceinline__ void reduce_rows(float (&a)[V], float (&b)[V],
                                            int lanes, int c, float* out_a,
                                            float* out_b) {
  __shared__ float sh[2][kWarps][32 * V];
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
      b[i] += __shfl_xor_sync(0xffffffffu, b[i], off);
    }
  }
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  if (wl < lanes) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sh[0][warp][wl * V + i] = a[i];
      sh[1][warp][wl * V + i] = b[i];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < lanes * V) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += sh[0][w][t];
      sb += sh[1][w][t];
    }
    const int ch = blockIdx.y * lanes * V + t;
    if (ch < c) {
      out_a[ch] = sa;
      out_b[ch] = sb;
    }
  }
}

// partial[0][blockIdx.x][c] = sum x, partial[1][blockIdx.x][c] = sum x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stats_rows(const T* __restrict__ x, long long m, int c, int lanes,
               float* __restrict__ partial) {
  const RowLanes r = row_lanes(lanes);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (r.group < c / V) {
    const T* base = x + static_cast<long long>(r.group) * V;
    long long row = r.row0;
    for (; row + (kUnroll - 1) * r.stride < m; row += kUnroll * r.stride) {
      Pack<T, V> p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) p[u].load(base + (row + u * r.stride) * c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += p[u].v[i];
          q[i] = fmaf(p[u].v[i], p[u].v[i], q[i]);
        }
      }
    }
    for (; row < m; row += r.stride) {
      Pack<T, V> p;
      p.load(base + row * c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += p.v[i];
        q[i] = fmaf(p.v[i], p.v[i], q[i]);
      }
    }
  }
  reduce_rows<V>(s, q, lanes, c, partial + static_cast<long long>(blockIdx.x) * c,
                 partial + static_cast<long long>(gridDim.x + blockIdx.x) * c);
}

// y = (x - mean) * mul + bias, mul = rstd * scale.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    normalize_rows(const T* __restrict__ x, T* __restrict__ y, long long m,
                   int c, int lanes, const float* __restrict__ mean,
                   const float* __restrict__ mul,
                   const float* __restrict__ shift) {
  const RowLanes r = row_lanes(lanes);
  if (r.group >= c / V) return;
  float mu[V], k[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = r.group * V + i;
    mu[i] = mean[ch];
    k[i] = mul[ch];
    b[i] = shift[ch];
  }
  const long long off = static_cast<long long>(r.group) * V;
  long long row = r.row0;
  for (; row + (kUnroll - 1) * r.stride < m; row += kUnroll * r.stride) {
    Pack<T, V> p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u].load(x + off + (row + u * r.stride) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        p[u].v[i] = __fadd_rn(__fmul_rn(__fsub_rn(p[u].v[i], mu[i]), k[i]), b[i]);
      }
      p[u].store(y + off + (row + u * r.stride) * c);
    }
  }
  for (; row < m; row += r.stride) {
    Pack<T, V> p;
    p.load(x + off + row * c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p.v[i] = __fadd_rn(__fmul_rn(__fsub_rn(p.v[i], mu[i]), k[i]), b[i]);
    }
    p.store(y + off + row * c);
  }
}

// partial[0][blockIdx.x][c] = sum dy, partial[1][blockIdx.x][c] =
// sum dy (x - mean).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_sums_rows(const T* __restrict__ dy, const T* __restrict__ x,
                   long long m, int c, int lanes,
                   const float* __restrict__ mean,
                   float* __restrict__ partial) {
  const RowLanes r = row_lanes(lanes);
  float s[V], q[V], mu[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = mu[i] = 0.f;
  if (r.group < c / V) {
#pragma unroll
    for (int i = 0; i < V; ++i) mu[i] = mean[r.group * V + i];
    const long long off = static_cast<long long>(r.group) * V;
    long long row = r.row0;
    for (; row + (kUnroll - 1) * r.stride < m; row += kUnroll * r.stride) {
      Pack<T, V> g[kUnroll], p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        g[u].load(dy + off + (row + u * r.stride) * c);
        p[u].load(x + off + (row + u * r.stride) * c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += g[u].v[i];
          q[i] = fmaf(g[u].v[i], p[u].v[i] - mu[i], q[i]);
        }
      }
    }
    for (; row < m; row += r.stride) {
      Pack<T, V> g, p;
      g.load(dy + off + row * c);
      p.load(x + off + row * c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += g.v[i];
        q[i] = fmaf(g.v[i], p.v[i] - mu[i], q[i]);
      }
    }
  }
  reduce_rows<V>(s, q, lanes, c, partial + static_cast<long long>(blockIdx.x) * c,
                 partial + static_cast<long long>(gridDim.x + blockIdx.x) * c);
}

// dx = A dy - B - K (x - mean), per channel (coef = [A; B; K]).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_input_rows(const T* __restrict__ dy, const T* __restrict__ x,
                    T* __restrict__ dx, long long m, int c, int lanes,
                    const float* __restrict__ mean,
                    const float* __restrict__ coef) {
  const RowLanes r = row_lanes(lanes);
  if (r.group >= c / V) return;
  float mu[V], ka[V], kb[V], kk[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = r.group * V + i;
    mu[i] = mean[ch];
    ka[i] = coef[ch];
    kb[i] = coef[c + ch];
    kk[i] = coef[2 * c + ch];
  }
  const long long off = static_cast<long long>(r.group) * V;
  long long row = r.row0;
  for (; row + (kUnroll - 1) * r.stride < m; row += kUnroll * r.stride) {
    Pack<T, V> g[kUnroll], p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g[u].load(dy + off + (row + u * r.stride) * c);
      p[u].load(x + off + (row + u * r.stride) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        g[u].v[i] = ka[i] * g[u].v[i] - kb[i] - kk[i] * (p[u].v[i] - mu[i]);
      }
      g[u].store(dx + off + (row + u * r.stride) * c);
    }
  }
  for (; row < m; row += r.stride) {
    Pack<T, V> g, p;
    g.load(dy + off + row * c);
    p.load(x + off + row * c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      g.v[i] = ka[i] * g.v[i] - kb[i] - kk[i] * (p.v[i] - mu[i]);
    }
    g.store(dx + off + row * c);
  }
}

// ---------------------------------------------------------------------------
// Planes layout: x as [N, C, P], each (n, c) plane contiguous. Block
// (blockIdx.x, c): its warps take units u = blockIdx.x * kWarps + warp,
// stride gridDim.x * kWarps, of N * chunks units; unit u is chunk u % chunks
// of plane u / chunks.

// Calls vec(offset) for each V-vector of the unit's chunk and one(offset)
// for each scalar of the plane's head and tail (chunk 0 only); offsets are
// elements from the plane's start. `misalign` is the plane start's
// distance past a 16-byte boundary, in elements.
template <int V, typename Vec, typename One>
__device__ __forceinline__ void walk_chunk(long long p, int misalign,
                                           int chunk, int chunks, Vec&& vec,
                                           One&& one) {
  const int lane = threadIdx.x & 31;
  long long head = 0;
  if (V > 1 && misalign != 0) head = V - misalign;
  if (head > p) head = p;
  const long long nvec = (p - head) / V;
  const long long per = (nvec + chunks - 1) / chunks;
  const long long lo = chunk * per;
  const long long hi = lo + per < nvec ? lo + per : nvec;
  long long j = lo + lane;
  for (; j + 32 * (kUnroll - 1) < hi; j += 32 * kUnroll) {
    vec.template run<kUnroll>(head + j * V, 32 * V);
  }
  for (; j < hi; j += 32) vec.template run<1>(head + j * V, 32 * V);
  if (chunk == 0) {
    const long long tail = head + nvec * V;
    if (lane < head) one(lane);
    if (tail + lane < p) one(tail + lane);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums a and b over the block and writes them as the block's partial of
// channel blockIdx.y.
__device__ __forceinline__ void reduce_planes(float a, float b, int c,
                                              float* partial) {
  __shared__ float sh[2][kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += sh[0][w];
      sb += sh[1][w];
    }
    partial[static_cast<long long>(blockIdx.x) * c + blockIdx.y] = sa;
    partial[static_cast<long long>(gridDim.x + blockIdx.x) * c + blockIdx.y] = sb;
  }
}

template <typename T>
__device__ __forceinline__ int misalignment(const T* p, int V) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % V);
}

template <typename T, int V>
struct StatsVec {
  const T* plane;
  float s, q;
  template <int U>
  __device__ __forceinline__ void run(long long o, long long step) {
    Pack<T, V> p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) p[u].load(plane + o + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s += p[u].v[i];
        q = fmaf(p[u].v[i], p[u].v[i], q);
      }
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stats_planes(const T* __restrict__ x, long long n, int c, long long p,
                 int chunks, float* __restrict__ partial) {
  const int ch = blockIdx.y;
  StatsVec<T, V> acc{nullptr, 0.f, 0.f};
  const long long units = n * chunks;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       u < units; u += static_cast<long long>(gridDim.x) * kWarps) {
    acc.plane = x + (u / chunks * c + ch) * p;
    walk_chunk<V>(p, misalignment(acc.plane, V), static_cast<int>(u % chunks),
                  chunks, acc, [&](long long o) {
                    const float v = to_f32(acc.plane[o]);
                    acc.s += v;
                    acc.q = fmaf(v, v, acc.q);
                  });
  }
  reduce_planes(acc.s, acc.q, c, partial);
}

template <typename T, int V>
struct NormalizeVec {
  const T* src;
  T* dst;
  float mu, k, b;
  template <int U>
  __device__ __forceinline__ void run(long long o, long long step) {
    Pack<T, V> p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) p[u].load(src + o + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        p[u].v[i] = __fadd_rn(__fmul_rn(__fsub_rn(p[u].v[i], mu), k), b);
      }
      p[u].store(dst + o + u * step);
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    normalize_planes(const T* __restrict__ x, T* __restrict__ y, long long n,
                     int c, long long p, int chunks,
                     const float* __restrict__ mean,
                     const float* __restrict__ mul,
                     const float* __restrict__ shift) {
  const int ch = blockIdx.y;
  NormalizeVec<T, V> f{nullptr, nullptr, mean[ch], mul[ch], shift[ch]};
  const long long units = n * chunks;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       u < units; u += static_cast<long long>(gridDim.x) * kWarps) {
    const long long base = (u / chunks * c + ch) * p;
    f.src = x + base;
    f.dst = y + base;
    walk_chunk<V>(p, misalignment(f.src, V), static_cast<int>(u % chunks),
                  chunks, f, [&](long long o) {
                    f.dst[o] = from_f32<T>(__fadd_rn(
                        __fmul_rn(__fsub_rn(to_f32(f.src[o]), f.mu), f.k), f.b));
                  });
  }
}

template <typename T, int V>
struct GradSumsVec {
  const T* g;
  const T* x;
  float mu, s, q;
  template <int U>
  __device__ __forceinline__ void run(long long o, long long step) {
    Pack<T, V> a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u].load(g + o + u * step);
      b[u].load(x + o + u * step);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s += a[u].v[i];
        q = fmaf(a[u].v[i], b[u].v[i] - mu, q);
      }
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_sums_planes(const T* __restrict__ dy, const T* __restrict__ x,
                     long long n, int c, long long p, int chunks,
                     const float* __restrict__ mean,
                     float* __restrict__ partial) {
  const int ch = blockIdx.y;
  GradSumsVec<T, V> acc{nullptr, nullptr, mean[ch], 0.f, 0.f};
  const long long units = n * chunks;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       u < units; u += static_cast<long long>(gridDim.x) * kWarps) {
    const long long base = (u / chunks * c + ch) * p;
    acc.g = dy + base;
    acc.x = x + base;
    walk_chunk<V>(p, misalignment(acc.g, V), static_cast<int>(u % chunks),
                  chunks, acc, [&](long long o) {
                    const float gv = to_f32(acc.g[o]);
                    acc.s += gv;
                    acc.q = fmaf(gv, to_f32(acc.x[o]) - acc.mu, acc.q);
                  });
  }
  reduce_planes(acc.s, acc.q, c, partial);
}

template <typename T, int V>
struct GradInputVec {
  const T* g;
  const T* x;
  T* dx;
  float mu, ka, kb, kk;
  template <int U>
  __device__ __forceinline__ void run(long long o, long long step) {
    Pack<T, V> a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u].load(g + o + u * step);
      b[u].load(x + o + u * step);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a[u].v[i] = ka * a[u].v[i] - kb - kk * (b[u].v[i] - mu);
      }
      a[u].store(dx + o + u * step);
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_input_planes(const T* __restrict__ dy, const T* __restrict__ x,
                      T* __restrict__ dx, long long n, int c, long long p,
                      int chunks, const float* __restrict__ mean,
                      const float* __restrict__ coef) {
  const int ch = blockIdx.y;
  GradInputVec<T, V> f{nullptr, nullptr, nullptr, mean[ch], coef[ch],
                       coef[c + ch], coef[2 * c + ch]};
  const long long units = n * chunks;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       u < units; u += static_cast<long long>(gridDim.x) * kWarps) {
    const long long base = (u / chunks * c + ch) * p;
    f.g = dy + base;
    f.x = x + base;
    f.dx = dx + base;
    walk_chunk<V>(p, misalignment(f.g, V), static_cast<int>(u % chunks),
                  chunks, f, [&](long long o) {
                    f.dx[o] = from_f32<T>(f.ka * to_f32(f.g[o]) - f.kb -
                                          f.kk * (to_f32(f.x[o]) - f.mu));
                  });
  }
}

// ---------------------------------------------------------------------------
// Finalise: block of kThreads = kFinalTile channels x kWarps slices of the
// S partials; each thread sums its slice in float64.

__device__ __forceinline__ bool sum_partials(const float* partial, int slabs,
                                             int c, double& a, double& b) {
  __shared__ double sh[2][kWarps][kFinalTile];
  const int cl = threadIdx.x % kFinalTile, sl = threadIdx.x / kFinalTile;
  const int ch = blockIdx.x * kFinalTile + cl;
  a = 0.0;
  b = 0.0;
  if (ch < c) {
    for (int s = sl; s < slabs; s += kWarps) {
      a += partial[static_cast<long long>(s) * c + ch];
      b += partial[static_cast<long long>(slabs + s) * c + ch];
    }
  }
  sh[0][sl][cl] = a;
  sh[1][sl][cl] = b;
  __syncthreads();
  if (sl != 0 || ch >= c) return false;
  for (int j = 1; j < kWarps; ++j) {
    a += sh[0][j][cl];
    b += sh[1][j][cl];
  }
  return true;
}

// mean, rstd; mul = rstd * scale and shift = bias for the normalise pass;
// the new running statistics.
__global__ void __launch_bounds__(kThreads)
    finalize_forward(const float* __restrict__ partial, int slabs, int c,
                     long long count, const float* __restrict__ run_mean,
                     const float* __restrict__ run_var, const void* scale,
                     const void* bias, int param_bf16, float momentum,
                     float one_minus, float eps, float* __restrict__ new_mean,
                     float* __restrict__ new_var, float* __restrict__ mean,
                     float* __restrict__ rstd, float* __restrict__ mul,
                     float* __restrict__ shift) {
  double a, b;
  if (!sum_partials(partial, slabs, c, a, b)) return;
  const int ch = blockIdx.x * kFinalTile + threadIdx.x % kFinalTile;
  const double m = a / static_cast<double>(count);
  const double v = fmax(b / static_cast<double>(count) - m * m, 0.0);
  const float mf = static_cast<float>(m), vf = static_cast<float>(v);
  const float r = static_cast<float>(1.0 / sqrt(static_cast<double>(__fadd_rn(vf, eps))));
  mean[ch] = mf;
  rstd[ch] = r;
  mul[ch] = __fmul_rn(r, param(scale, param_bf16, ch, 1.f));
  shift[ch] = param(bias, param_bf16, ch, 0.f);
  new_mean[ch] = __fadd_rn(__fmul_rn(momentum, run_mean[ch]), __fmul_rn(one_minus, mf));
  new_var[ch] = __fadd_rn(__fmul_rn(momentum, run_var[ch]), __fmul_rn(one_minus, vf));
}

// dbias = sum dy, dscale = sum dy x^ (in the parameters' dtype), and the
// coefficients of dx = A dy - B - K (x - mean): A = scale rstd,
// B = A sum(dy) / M, K = A rstd sum(dy x^) / M.
__global__ void __launch_bounds__(kThreads)
    finalize_backward(const float* __restrict__ partial, int slabs, int c,
                      long long count, const float* __restrict__ rstd,
                      const void* scale, int param_bf16, void* dscale,
                      void* dbias, float* __restrict__ coef) {
  double a, b;
  if (!sum_partials(partial, slabs, c, a, b)) return;
  const int ch = blockIdx.x * kFinalTile + threadIdx.x % kFinalTile;
  const double r = rstd[ch];
  const double dxhat = b * r;  // sum dy x^
  store_param(dbias, param_bf16, ch, static_cast<float>(a));
  store_param(dscale, param_bf16, ch, static_cast<float>(dxhat));
  const double ka = static_cast<double>(
      __fmul_rn(rstd[ch], param(scale, param_bf16, ch, 1.f)));
  coef[ch] = static_cast<float>(ka);
  coef[c + ch] = static_cast<float>(ka * a / static_cast<double>(count));
  coef[2 * c + ch] = static_cast<float>(ka * r * dxhat / static_cast<double>(count));
}

// ---------------------------------------------------------------------------
// Launch.

enum Layout { kRows = 0, kPlanes = 1 };

struct Grid {
  int layout, c, grid_x, grid_y, split;  // split: lanes (rows), chunks (planes)
  long long outer, inner;                 // rows: M, 1; planes: N, P
};

template <typename T, int V>
cudaError_t forward_t(const Grid& g, const void* x, void* y,
                      const void* scale, const void* bias, int param_bf16,
                      const float* run_mean, const float* run_var,
                      float momentum, float one_minus, float eps,
                      float* new_mean, float* new_var, float* mean,
                      float* rstd, float* partial, float* scratch,
                      cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 grid(g.grid_x, g.grid_y);
  if (g.layout == kRows) {
    stats_rows<T, V><<<grid, kThreads, 0, stream>>>(xt, g.outer, g.c, g.split, partial);
  } else {
    stats_planes<T, V><<<grid, kThreads, 0, stream>>>(xt, g.outer, g.c, g.inner,
                                                      g.split, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* mul = scratch;
  float* shift = scratch + g.c;
  finalize_forward<<<(g.c + kFinalTile - 1) / kFinalTile, kThreads, 0, stream>>>(
      partial, g.grid_x, g.c, g.outer * g.inner, run_mean, run_var, scale, bias,
      param_bf16, momentum, one_minus, eps, new_mean, new_var, mean, rstd, mul,
      shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (g.layout == kRows) {
    normalize_rows<T, V><<<grid, kThreads, 0, stream>>>(xt, yt, g.outer, g.c, g.split,
                                                        mean, mul, shift);
  } else {
    normalize_planes<T, V><<<grid, kThreads, 0, stream>>>(
        xt, yt, g.outer, g.c, g.inner, g.split, mean, mul, shift);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t backward_t(const Grid& g, const void* dy, const void* x,
                       const void* scale, int param_bf16, const float* mean,
                       const float* rstd, void* dx, void* dscale, void* dbias,
                       float* partial, float* coef, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  const dim3 grid(g.grid_x, g.grid_y);
  if (g.layout == kRows) {
    grad_sums_rows<T, V><<<grid, kThreads, 0, stream>>>(gt, xt, g.outer, g.c, g.split,
                                                        mean, partial);
  } else {
    grad_sums_planes<T, V><<<grid, kThreads, 0, stream>>>(
        gt, xt, g.outer, g.c, g.inner, g.split, mean, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_backward<<<(g.c + kFinalTile - 1) / kFinalTile, kThreads, 0, stream>>>(
      partial, g.grid_x, g.c, g.outer * g.inner, rstd, scale, param_bf16, dscale,
      dbias, coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (g.layout == kRows) {
    grad_input_rows<T, V><<<grid, kThreads, 0, stream>>>(gt, xt, dxt, g.outer, g.c,
                                                         g.split, mean, coef);
  } else {
    grad_input_planes<T, V><<<grid, kThreads, 0, stream>>>(
        gt, xt, dxt, g.outer, g.c, g.inner, g.split, mean, coef);
  }
  return cudaGetLastError();
}

bool valid(const Grid& g) {
  if (g.layout != kRows && g.layout != kPlanes) return false;
  if (g.c <= 0 || g.outer <= 0 || g.inner <= 0 || g.grid_x <= 0 ||
      g.grid_y <= 0 || g.grid_y > 65535 || g.split <= 0) {
    return false;
  }
  // rows: lanes a power of two up to 32
  if (g.layout == kRows && (g.split > 32 || (g.split & (g.split - 1)) != 0)) {
    return false;
  }
  return true;
}

}  // namespace

// dtype: 0 float32, 1 bf16. vec: 1 for 16-byte vectors (C a multiple of V
// in rows, every pointer 16-byte aligned), 0 for scalars. partial holds
// 2 * grid_x * c floats, scratch 2 * c.
extern "C" int t2r_batch_norm_fwd(
    const void* x, void* y, const void* scale, const void* bias,
    const void* run_mean, const void* run_var, void* new_mean, void* new_var,
    void* mean, void* rstd, void* partial, void* scratch, int layout,
    int dtype, int vec, int param_bf16, int c, int grid_x, int grid_y,
    int split, long long outer, long long inner, float momentum,
    float one_minus, float eps, void* stream) {
  const Grid g{layout, c, grid_x, grid_y, split, outer, inner};
  if (!valid(g) || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rm = static_cast<const float*>(run_mean);
  const auto rv = static_cast<const float*>(run_var);
  const auto nm = static_cast<float*>(new_mean);
  const auto nv = static_cast<float*>(new_var);
  const auto mu = static_cast<float*>(mean);
  const auto rs = static_cast<float*>(rstd);
  const auto pa = static_cast<float*>(partial);
  const auto sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? forward_t<float, 4>(g, x, y, scale, bias, param_bf16, rm, rv,
                                    momentum, one_minus, eps, nm, nv, mu, rs,
                                    pa, sc, s)
              : forward_t<float, 1>(g, x, y, scale, bias, param_bf16, rm, rv,
                                    momentum, one_minus, eps, nm, nv, mu, rs,
                                    pa, sc, s);
  } else {
    err = vec ? forward_t<__nv_bfloat16, 8>(g, x, y, scale, bias, param_bf16,
                                            rm, rv, momentum, one_minus, eps,
                                            nm, nv, mu, rs, pa, sc, s)
              : forward_t<__nv_bfloat16, 1>(g, x, y, scale, bias, param_bf16,
                                            rm, rv, momentum, one_minus, eps,
                                            nm, nv, mu, rs, pa, sc, s);
  }
  return static_cast<int>(err);
}

// dscale and dbias in the parameters' dtype (param_bf16), either may be
// null; partial holds 2 * grid_x * c floats, coef 3 * c.
extern "C" int t2r_batch_norm_bwd(
    const void* dy, const void* x, const void* scale, const void* mean,
    const void* rstd, void* dx, void* dscale, void* dbias, void* partial,
    void* coef, int layout, int dtype, int vec, int param_bf16, int c,
    int grid_x, int grid_y, int split, long long outer, long long inner,
    void* stream) {
  const Grid g{layout, c, grid_x, grid_y, split, outer, inner};
  if (!valid(g) || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto mu = static_cast<const float*>(mean);
  const auto rs = static_cast<const float*>(rstd);
  const auto pa = static_cast<float*>(partial);
  const auto co = static_cast<float*>(coef);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? backward_t<float, 4>(g, dy, x, scale, param_bf16, mu, rs, dx,
                                     dscale, dbias, pa, co, s)
              : backward_t<float, 1>(g, dy, x, scale, param_bf16, mu, rs, dx,
                                     dscale, dbias, pa, co, s);
  } else {
    err = vec ? backward_t<__nv_bfloat16, 8>(g, dy, x, scale, param_bf16, mu,
                                             rs, dx, dscale, dbias, pa, co, s)
              : backward_t<__nv_bfloat16, 1>(g, dy, x, scale, param_bf16, mu,
                                             rs, dx, dscale, dbias, pa, co, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* t2r_batch_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

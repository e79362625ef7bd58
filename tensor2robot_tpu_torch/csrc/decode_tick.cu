// Fused session decode tick for Hopper (sm_90a).
//
// Replaces: tensor2robot_tpu/ops/decode_kernels.py `_decode_tick_kernel`
// (launched by `fused_decode_attention`), the Pallas TPU kernel that runs
// once per attention block on every SessionEngine control tick.
//
// What it computes, per lane b and head h: a one-row softmax attention of
// q[b, h] over the lane's own arena rows k_arena[slot, t < index, h] plus
// this tick's k_new[b, h] as the last position, written to out[b, h]; then,
// for live lanes only (mask != 0), k_new / v_new are stored IN PLACE at
// arena row (slot, index). Pad lanes write nothing, so the null slot 0 and
// every row other than (slot, index) of a live lane stay bit-identical.
// Rows read are strictly below `index`, so the write never races a read.
//
// What bounds it on an H100: bytes. Each lane streams 2 * index * D * 4
// bytes per head from HBM and does 4 flops per byte read, far below the
// card's ~20 flop/byte f32 balance point.
//
// What the design does about it: one thread block per (lane, head). A
// group of D/4 threads reads one arena row as float4s, so a group's load
// is one contiguous D*4-byte segment; the block's 128 threads keep
// 128/(D/4) rows in flight, UNROLL deep. Each group keeps its own running
// (max, sum, numerator) in f32 registers; a shared-memory merge combines
// the groups, then absorbs k_new / v_new. The TPU kernel's sequential
// (lane, k-block) grid becomes the in-block loop, and its scalar-prefetched
// slots / index / mask become per-block loads. Split-T (flash-decoding)
// for buckets with few lanes, and TMA, are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tick_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_new,
                   const float* __restrict__ v_new,
                   float* __restrict__ k_arena,
                   float* __restrict__ v_arena,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ index,
                   const uint8_t* __restrict__ mask,
                   float* __restrict__ out,
                   int t_max, int num_heads, float scale) {
  constexpr int G = D / 4;            // threads per arena row (one float4 each)
  constexpr int NG = kThreads / G;    // rows in flight per unroll step
  const int lane = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int g = tid / G;
  const int e = tid % G;

  const int slot = slots[lane];
  const int idx_raw = index[lane];
  // Rows strictly below the index are read; the clamp keeps a bad index
  // from reading outside the slot (the engine's horizon guard keeps
  // index < T, so the clamp is inactive on the served path).
  const int idx = min(max(idx_raw, 0), t_max);
  const size_t row_stride = static_cast<size_t>(num_heads) * D;
  const size_t slot_base =
      static_cast<size_t>(slot) * t_max * row_stride + static_cast<size_t>(h) * D;
  const size_t vec = (static_cast<size_t>(lane) * num_heads + h) * D;

  const float4 qv = reinterpret_cast<const float4*>(q + vec)[e];
  const float4 knv = reinterpret_cast<const float4*>(k_new + vec)[e];

  // Score of this tick's own key (the appended position), reduced over
  // the group's G lanes; every group computes it.
  float s_new = qv.x * knv.x + qv.y * knv.y + qv.z * knv.z + qv.w * knv.w;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s_new += __shfl_xor_sync(0xffffffffu, s_new, o);
  s_new *= scale;

  float m = -INFINITY;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  // The trip count depends only on idx, so it is uniform over the block
  // and every lane of a warp reaches the shuffles together.
  for (int t0 = 0; t0 < idx; t0 += NG * kUnroll) {
    float4 kv[kUnroll];
    float4 vv[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * NG + g;
      valid[u] = t < idx;
      if (valid[u]) {
        const size_t off = slot_base + static_cast<size_t>(t) * row_stride;
        kv[u] = reinterpret_cast<const float4*>(k_arena + off)[e];
        vv[u] = reinterpret_cast<const float4*>(v_arena + off)[e];
      } else {
        kv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vv[u] = kv[u];
      }
    }
    float s[kUnroll];
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x = qv.x * kv[u].x + qv.y * kv[u].y + qv.z * kv[u].z + qv.w * kv[u].w;
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      s[u] = valid[u] ? x * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[u]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // this group had no row in this step
    const float alpha = __expf(m - m_new);
    l *= alpha;
    acc.x *= alpha; acc.y *= alpha; acc.z *= alpha; acc.w *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = valid[u] ? __expf(s[u] - m_new) : 0.f;
      l += p;
      acc.x += p * vv[u].x; acc.y += p * vv[u].y;
      acc.z += p * vv[u].z; acc.w += p * vv[u].w;
    }
    m = m_new;
  }

  // Merge the NG groups' partial softmax states.
  __shared__ float sm_m[NG];
  __shared__ float sm_l[NG];
  __shared__ float sm_o[NG][D];
  if (e == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
  sm_o[g][4 * e + 0] = acc.x;
  sm_o[g][4 * e + 1] = acc.y;
  sm_o[g][4 * e + 2] = acc.z;
  sm_o[g][4 * e + 3] = acc.w;
  __syncthreads();

  if (tid < D) {
    float m_fin = s_new;
#pragma unroll
    for (int j = 0; j < NG; ++j) m_fin = fmaxf(m_fin, sm_m[j]);
    const float p_new = __expf(s_new - m_fin);
    float l_fin = p_new;
    float o_fin = p_new * v_new[vec + tid];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (sm_m[j] != -INFINITY) {
        const float w = __expf(sm_m[j] - m_fin);
        l_fin += sm_l[j] * w;
        o_fin += sm_o[j][tid] * w;
      }
    }
    out[vec + tid] = o_fin / fmaxf(l_fin, 1e-30f);
  }

  // In-place append of this tick's K/V, live lanes only.
  if (mask[lane] != 0 && idx_raw >= 0 && idx_raw < t_max && tid < G) {
    const size_t off = slot_base + static_cast<size_t>(idx_raw) * row_stride;
    reinterpret_cast<float4*>(k_arena + off)[e] = knv;
    reinterpret_cast<float4*>(v_arena + off)[e] =
        reinterpret_cast<const float4*>(v_new + vec)[e];
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_arena, void* v_arena, const void* slots,
                   const void* index, const void* mask, void* out, int b,
                   int t_max, int num_heads, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(b, num_heads);
  decode_tick_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<float*>(k_arena),
      static_cast<float*>(v_arena), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(index), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), t_max, num_heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int t2r_decode_tick(const void* q, const void* k_new,
                               const void* v_new, void* k_arena,
                               void* v_arena, const void* slots,
                               const void* index, const void* mask, void* out,
                               int b, int t_max, int num_heads, int head_dim,
                               void* stream) {
  if (b <= 0 || t_max <= 0 || num_heads <= 0 || num_heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch<16>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, b, t_max, num_heads, s); break;
    case 32: err = launch<32>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, b, t_max, num_heads, s); break;
    case 64: err = launch<64>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, b, t_max, num_heads, s); break;
    case 128: err = launch<128>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, b, t_max, num_heads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* t2r_decode_tick_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused session decode tick for Hopper (sm_90a), split over T.
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
//
// What bounds it on an H100: bytes, 2 * sum(index) * H * D * 4 of K and V
// rows read once. It does 4 flops per byte, far below the card's ~20
// flop/byte f32 balance point, so the CUDA cores compute in f32 and the
// design is about keeping HBM busy.
//
// What the design does about it (flash-decoding in one launch):
// - Work split. One thread block per (lane, chunk of C arena rows, group
//   of heads). A group is every head while H * D * 4 <= 2 KB (the serving
//   widths, H 8 and D 64, make a 2 KB row), so a chunk of a slot's rows is
//   one contiguous span of the arena; wider rows split into groups whose
//   rows are each a contiguous span. The grid, ceil(T / C) x B x groups,
//   is sized on the host from B, T and H only (reading `index` would add a
//   synchronising copy to the tick); a block whose chunk starts at or past
//   its lane's index exits at once. The block of chunk 0 always runs.
// - Loads. One producer thread streams the chunk's K and V rows below the
//   index into a 4-stage shared-memory ring with 1-D bulk asynchronous
//   copies (`cp.async.bulk`, completing on an mbarrier): 16 KB a stage,
//   64 KB in flight per block. A ragged last chunk gets a shorter copy,
//   so no block reads row `index` while the chunk-0 block appends it.
// - Compute. Each consumer warp owns one head: D/4 lanes take a row as
//   float4s, the q.k dot is a shuffle reduction, and each row group keeps
//   its running (max, sum, numerator) in f32 registers; a butterfly merges
//   the warp's row groups.
// - A lane of one chunk (index <= C) has one block, which absorbs k_new /
//   v_new and writes `out` itself.
// - Otherwise the merge, in the same launch, is a two-level tree. Each
//   block writes its partial (m, l, o[group, D]) to scratch and takes a
//   ticket from the counter of its group of 16 chunks; the group's last
//   block streams the group's partials back through the same ring (bulk
//   copies again) and merges them in chunk order. With more than one
//   group it writes the group's state and takes a ticket from the lane's
//   counter, whose last block merges the groups' states in group order.
//   The final merger absorbs k_new / v_new as the last position and
//   writes `out`. Every merge runs in a fixed order, so two calls give
//   bit-identical `out` whatever order the blocks ended in; the last
//   block of each counter resets it to 0 for the next launch. A single
//   merging block (the plain shape of flash-decoding) would read every
//   partial through one SM, 128 of 2 KB at index 4095, one dependent
//   round trip after another; the tree's widest merge reads 16.
//
// C = 32 (the wrapper's DECODE_CHUNK): at B = 1 and index 4095 it makes 128
// working blocks for the 132 SMs, and at the timed B = 8 bucket (indices
// 4095 .. 1) about 350 (three 64 KB blocks fit an SM), so both served
// extremes fill the card. C = 16 would double the partials to merge, and
// C = 64 halve the working blocks at B = 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "hopper_common.cuh"

namespace {

using t2r_hopper::bulk_load_1d;
using t2r_hopper::fence_proxy_async_global;
using t2r_hopper::mbar_arrive;
using t2r_hopper::mbar_arrive_expect_tx;
using t2r_hopper::mbar_fence_init;
using t2r_hopper::mbar_init;
using t2r_hopper::mbar_wait;

constexpr int kStages = 4;
constexpr int kStageBytes = 16384;     // K + V rows of one ring stage
constexpr int kMaxGroupBytes = 2048;   // one group's share of an arena row
constexpr int kMaxGroupWarps = 16;     // consumer warps (heads) per block
constexpr int kMaxThreads = (kMaxGroupWarps + 1) * 32;
constexpr int kUnroll = 2;
constexpr int kFanIn = 16;             // partials per first-level merge
constexpr int kMaxDevices = 64;

// Reads EPL consecutive floats of shared memory as one vector.
template <int EPL>
__device__ __forceinline__ void load_smem(const float* src, float (&x)[EPL]) {
  if constexpr (EPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (EPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *src;
  }
}

// The ring: kStages stages of `stage_floats` floats, `full` / `empty`
// barriers per stage. Sub-tile j of a block (counted over all its phases)
// uses stage j % kStages in its (j / kStages)-th round.
struct Ring {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  int stage_floats;
};

// Producer: streams rows [0, n) of `src` (contiguous, `row_floats` each)
// into the ring, `per_stage` rows a stage, from sub-tile j on. Returns the
// next sub-tile.
__device__ __forceinline__ int produce_rows(const Ring& ring, int j,
                                            const float* src, int n,
                                            int row_floats, int per_stage) {
  for (int i = 0; i < n; i += per_stage, ++j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&ring.empty[s], ((j / kStages) - 1) & 1);
    const uint32_t bytes =
        static_cast<uint32_t>(min(per_stage, n - i) * row_floats) * 4;
    mbar_arrive_expect_tx(&ring.full[s], bytes);
    bulk_load_1d(ring.buf + static_cast<size_t>(s) * ring.stage_floats,
                 src + static_cast<size_t>(i) * row_floats, bytes, &ring.full[s]);
  }
  return j;
}

// A running softmax state of one head: max m, sum l, numerator o; lane
// `lane` holds elements [e0, e0 + EPL) of o.
template <int EPL>
struct Partial {
  float m = -INFINITY;
  float l = 0.f;
  float o[EPL] = {};

  // Absorbs another state (mc, lc, oc) in place, online.
  __device__ __forceinline__ void absorb(float mc, float lc, const float (&oc)[EPL]) {
    const float m_new = fmaxf(m, mc);
    if (m_new == -INFINITY) return;  // both empty
    const float a = __expf(m - m_new);   // 0 while this state is empty
    const float b = __expf(mc - m_new);  // 0 for an empty chunk
    l = l * a + lc * b;
#pragma unroll
    for (int i = 0; i < EPL; ++i) o[i] = o[i] * a + oc[i] * b;
    m = m_new;
  }
};

// Consumer warp: absorbs, in order, rows [0, n) streamed by produce_rows
// with the same (j, row_floats, per_stage): of each row its head's o at
// `o_off` + e0 and (m, l) at `ml_off`. Returns the next sub-tile.
template <int EPL>
__device__ __forceinline__ int merge_rows(const Ring& ring, int j, int n,
                                          int row_floats, int per_stage,
                                          int o_off, int ml_off,
                                          Partial<EPL>& acc) {
  const int lane = threadIdx.x % 32;
  for (int i0 = 0; i0 < n; i0 += per_stage, ++j) {
    const int s = j % kStages;
    mbar_wait(&ring.full[s], (j / kStages) & 1);
    const float* rows = ring.buf + static_cast<size_t>(s) * ring.stage_floats;
    const int count = min(per_stage, n - i0);
    for (int i = 0; i < count; ++i) {
      const float* row = rows + i * row_floats;
      float oc[EPL];
      load_smem<EPL>(row + o_off, oc);
      acc.absorb(row[ml_off], row[ml_off + 1], oc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[s]);
  }
  return j;
}

// Publishes this block's writes, takes a ticket from `counter`, and tells
// whether it was the last of `count`; the last block resets the counter
// to 0 for the next launch. Called by every thread of the block. The
// barrier orders the block's writes before thread 0's release fence and
// ticket (one fence for the block, not one per thread); the acquire fence
// and the barrier after it order every earlier block's writes before this
// block's reads, and the proxy fence before its bulk copies of them.
__device__ __forceinline__ bool last_ticket(int32_t* counter, int count,
                                            int* is_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int ticket;
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "atom.add.relaxed.gpu.global.s32 %0, [%1], 1;\n"
        "fence.acq_rel.gpu;\n"
        : "=r"(ticket) : "l"(counter) : "memory");
    *is_last = ticket == count - 1;
    if (*is_last) *counter = 0;
  }
  __syncthreads();
  const bool last = *is_last;
  if (last) fence_proxy_async_global();
  return last;
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
decode_tick_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_new,
                   const float* __restrict__ v_new,
                   float* k_arena, float* v_arena,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ index,
                   const uint8_t* __restrict__ mask,
                   float* __restrict__ out, float* partials,
                   int32_t* counters, int t_max, int num_heads,
                   int group_heads, int chunk, int stage_rows, float scale) {
  constexpr int L = D / 4;       // lanes per arena row, a float4 each
  constexpr int RPS = 32 / L;    // rows a warp takes per step
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // o elements a lane merges
  const int c = blockIdx.x;
  const int lane_b = blockIdx.y;
  const int g = blockIdx.z;
  const int idx_raw = index[lane_b];
  // Rows strictly below the index are read; the clamp keeps a bad index
  // from reading outside the slot (the engine's horizon guard keeps
  // index < T, so the clamp is inactive on the served path).
  const int idx = min(max(idx_raw, 0), t_max);
  const int c0 = c * chunk;
  if (c > 0 && c0 >= idx) return;
  const int nchunks = max(1, (idx + chunk - 1) / chunk);
  const int rows = max(0, min(chunk, idx - c0));
  const int nsub = (rows + stage_rows - 1) / stage_rows;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group_floats = group_heads * D;
  const size_t row_stride = static_cast<size_t>(num_heads) * D;
  const size_t slot_base = static_cast<size_t>(slots[lane_b]) * t_max * row_stride;
  const size_t group_base = slot_base + static_cast<size_t>(g) * group_floats;

  // Partials of this (lane, group): the chunks' (level 0), then one per
  // group of kFanIn chunks (level 1). A partial is o [group_heads, D],
  // then (m, l) per head, padded to 16 bytes. Counters: one per level-1
  // group, then one for the lane.
  const int part_row = group_floats + ((2 * group_heads + 3) & ~3);
  const int lg = lane_b * gridDim.z + g;
  const int groups_max = (gridDim.x + kFanIn - 1) / kFanIn;
  const size_t n_lg = static_cast<size_t>(gridDim.y) * gridDim.z;
  float* level0 = partials + static_cast<size_t>(lg) * gridDim.x * part_row;
  float* level1 = partials + n_lg * gridDim.x * part_row
                  + static_cast<size_t>(lg) * groups_max * part_row;
  int32_t* group_counters = counters + static_cast<size_t>(lg) * groups_max;
  int32_t* lane_counter = counters + n_lg * groups_max + lg;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages];
  __shared__ uint64_t empty[kStages];
  __shared__ int is_last;
  const Ring ring{reinterpret_cast<float*>(smem), full, empty,
                  2 * stage_rows * group_floats};  // K rows, then V rows

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], group_heads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const bool producer = warp == group_heads;
  // Consumer warp `warp` owns head h of the group.
  const int h = g * group_heads + (producer ? 0 : warp);
  const size_t vec = (static_cast<size_t>(lane_b) * num_heads + h) * D;
  if (producer) {
    // One thread keeps up to kStages sub-tiles of the chunk in flight.
    if (lane == 0) {
      const bool contiguous = static_cast<size_t>(group_floats) == row_stride;
      for (int j = 0; j < nsub; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        const int n = min(stage_rows, rows - j * stage_rows);
        const uint32_t row_bytes = static_cast<uint32_t>(group_floats) * 4;
        mbar_arrive_expect_tx(&full[s], 2 * n * row_bytes);
        float* kd = ring.buf + static_cast<size_t>(s) * ring.stage_floats;
        float* vd = kd + static_cast<size_t>(stage_rows) * group_floats;
        const size_t src = group_base
                           + static_cast<size_t>(c0 + j * stage_rows) * row_stride;
        if (contiguous) {
          bulk_load_1d(kd, k_arena + src, n * row_bytes, &full[s]);
          bulk_load_1d(vd, v_arena + src, n * row_bytes, &full[s]);
        } else {
          for (int r = 0; r < n; ++r) {
            const size_t off = src + static_cast<size_t>(r) * row_stride;
            bulk_load_1d(kd + r * group_floats, k_arena + off, row_bytes, &full[s]);
            bulk_load_1d(vd + r * group_floats, v_arena + off, row_bytes, &full[s]);
          }
        }
      }
    }
  } else {
    const int r = lane / L;
    const int e = lane % L;
    const float4 qv = reinterpret_cast<const float4*>(q + vec)[e];

    // In-place append of this tick's K/V, live lanes only, by chunk 0's
    // block. No block reads row idx_raw: every copy ends below it.
    if (c == 0 && r == 0 && mask[lane_b] != 0 && idx_raw >= 0 && idx_raw < t_max) {
      const size_t off = slot_base + static_cast<size_t>(idx_raw) * row_stride
                         + static_cast<size_t>(h) * D;
      reinterpret_cast<float4*>(k_arena + off)[e] =
          reinterpret_cast<const float4*>(k_new + vec)[e];
      reinterpret_cast<float4*>(v_arena + off)[e] =
          reinterpret_cast<const float4*>(v_new + vec)[e];
    }

    float m = -INFINITY;
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const int row_vecs = group_floats / 4;  // float4s per stored row
    for (int j = 0; j < nsub; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const int n = min(stage_rows, rows - j * stage_rows);
      const float4* ks = reinterpret_cast<const float4*>(
          ring.buf + static_cast<size_t>(s) * ring.stage_floats) + warp * L + e;
      const float4* vs = ks + static_cast<size_t>(stage_rows) * row_vecs;
      // The trip count depends only on n, uniform over the warp, so every
      // lane reaches the shuffles together.
      for (int i0 = 0; i0 < n; i0 += RPS * kUnroll) {
        float4 kv[kUnroll];
        float4 vv[kUnroll];
        bool valid[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = i0 + u * RPS + r;
          valid[u] = t < n;
          if (valid[u]) {
            kv[u] = ks[t * row_vecs];
            vv[u] = vs[t * row_vecs];
          } else {
            kv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            vv[u] = kv[u];
          }
        }
        float sc[kUnroll];
        float tile_max = -INFINITY;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float x = qv.x * kv[u].x + qv.y * kv[u].y + qv.z * kv[u].z + qv.w * kv[u].w;
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
          sc[u] = valid[u] ? x * scale : -INFINITY;
          tile_max = fmaxf(tile_max, sc[u]);
        }
        const float m_new = fmaxf(m, tile_max);
        // m_new is -inf only while this row group has seen no row.
        const float alpha = m_new == -INFINITY ? 1.f : __expf(m - m_new);
        l *= alpha;
        acc.x *= alpha; acc.y *= alpha; acc.z *= alpha; acc.w *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float p = valid[u] ? __expf(sc[u] - m_new) : 0.f;
          l += p;
          acc.x += p * vv[u].x; acc.y += p * vv[u].y;
          acc.z += p * vv[u].z; acc.w += p * vv[u].w;
        }
        m = m_new;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage may be refilled
    }

    // Merge the warp's RPS row groups (lanes r * L + e) by a butterfly.
    float m_all = m;
#pragma unroll
    for (int o = L; o < 32; o <<= 1) m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
    const float w = m == -INFINITY ? 0.f : __expf(m - m_all);
    l *= w;
    acc.x *= w; acc.y *= w; acc.z *= w; acc.w *= w;
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, o);
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (nchunks == 1) {
      // The lane's only block: absorb this tick's key and value now, with
      // no partial, ticket or merge.
      const float4 knv = reinterpret_cast<const float4*>(k_new + vec)[e];
      const float4 vnv = reinterpret_cast<const float4*>(v_new + vec)[e];
      float qk = qv.x * knv.x + qv.y * knv.y + qv.z * knv.z + qv.w * knv.w;
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) qk += __shfl_xor_sync(0xffffffffu, qk, o);
      const float s_new = qk * scale;
      const float m_fin = fmaxf(m_all, s_new);
      const float a = __expf(m_all - m_fin);
      const float p_new = __expf(s_new - m_fin);
      const float inv = 1.f / fmaxf(l * a + p_new, 1e-30f);
      if (r == 0) {
        reinterpret_cast<float4*>(out + vec)[e] = make_float4(
            (acc.x * a + p_new * vnv.x) * inv, (acc.y * a + p_new * vnv.y) * inv,
            (acc.z * a + p_new * vnv.z) * inv, (acc.w * a + p_new * vnv.w) * inv);
      }
      return;
    }
    float* part = level0 + static_cast<size_t>(c) * part_row;
    if (r == 0) reinterpret_cast<float4*>(part + warp * D)[e] = acc;
    if (lane == 0) {
      part[group_floats + 2 * warp] = m_all;
      part[group_floats + 2 * warp + 1] = l;
    }
  }
  if (nchunks == 1) return;  // the producer warp

  // The merge tree, in chunk order at every level, so two calls give the
  // same bits whatever order the blocks ended in. Level 1: the last block
  // of each group of kFanIn chunks merges the group's partials; level 2:
  // the last of those merges the groups'. One group: level 1 is the last.
  // The merges stream partials through the ring; their sub-tiles continue
  // the chunk's count (j), and so the barriers' parities.
  const int group = c / kFanIn;
  const int groups = (nchunks + kFanIn - 1) / kFanIn;
  const int in_group = min(kFanIn, nchunks - group * kFanIn);
  if (!last_ticket(group_counters + group, in_group, &is_last)) return;

  const int per_stage = ring.stage_floats / part_row;  // partials per stage
  const int e0 = min(lane, D / EPL - 1) * EPL;  // D 16: lanes 16.. repeat 15
  const int o_off = (producer ? 0 : warp) * D + e0;
  const int ml_off = group_floats + 2 * (producer ? 0 : warp);
  Partial<EPL> merged;
  int j = nsub;
  if (producer) {
    if (lane == 0) {
      j = produce_rows(ring, j, level0 + static_cast<size_t>(group) * kFanIn * part_row,
                       in_group, part_row, per_stage);
    }
  } else {
    j = merge_rows<EPL>(ring, j, in_group, part_row, per_stage, o_off, ml_off, merged);
  }
  if (groups > 1) {
    // Write this group's merged state, then the lane's ticket.
    float* row = level1 + static_cast<size_t>(group) * part_row;
    if (!producer) {
      if (lane * EPL < D) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) row[o_off + i] = merged.o[i];
      }
      if (lane == 0) {
        row[ml_off] = merged.m;
        row[ml_off + 1] = merged.l;
      }
    }
    if (!last_ticket(lane_counter, groups, &is_last)) return;
    merged = Partial<EPL>();
    if (producer) {
      if (lane == 0) produce_rows(ring, j, level1, groups, part_row, per_stage);
    } else {
      merge_rows<EPL>(ring, j, groups, part_row, per_stage, o_off, ml_off, merged);
    }
  }
  if (producer) return;

  // This tick's own key and value, absorbed as the last position.
  float qk = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) qk += q[vec + e0 + i] * k_new[vec + e0 + i];
  if (lane * EPL >= D) qk = 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qk += __shfl_xor_sync(0xffffffffu, qk, o);
  const float s_new = qk * scale;
  const float m_fin = fmaxf(merged.m, s_new);
  const float a = __expf(merged.m - m_fin);
  const float p_new = __expf(s_new - m_fin);
  const float inv = 1.f / fmaxf(merged.l * a + p_new, 1e-30f);
  if (lane * EPL < D) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      out[vec + e0 + i] = (merged.o[i] * a + p_new * v_new[vec + e0 + i]) * inv;
    }
  }
}

// Heads per block: the largest divisor of H whose share of a row fits
// kMaxGroupBytes, at most kMaxGroupWarps.
int group_heads_for(int num_heads, int head_dim) {
  int best = 1;
  for (int hg = 1; hg <= num_heads && hg <= kMaxGroupWarps; ++hg) {
    if (num_heads % hg == 0 && hg * head_dim * 4 <= kMaxGroupBytes) best = hg;
  }
  return best;
}

template <int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_arena, void* v_arena, const void* slots,
                   const void* index, const void* mask, void* out,
                   void* partials, void* counters, int b, int t_max,
                   int num_heads, int chunk, cudaStream_t stream) {
  const int hg = group_heads_for(num_heads, D);
  const int groups = num_heads / hg;
  const int row_bytes = hg * D * 4;
  const int stage_rows = std::max(1, std::min(chunk, kStageBytes / (2 * row_bytes)));
  const int smem = kStages * 2 * stage_rows * row_bytes;
  if (groups > 65535) return cudaErrorInvalidValue;
  // The shared-memory opt-in, once per device and size (it would cost
  // host time on every tick otherwise).
  static std::atomic<int> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > opted_in[device].load()) {
    err = cudaFuncSetAttribute(decode_tick_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[device].store(smem);
  }
  const int nchunk = (t_max + chunk - 1) / chunk;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(nchunk, b, groups);
  decode_tick_kernel<D><<<grid, (hg + 1) * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<float*>(k_arena),
      static_cast<float*>(v_arena), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(index), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), static_cast<float*>(partials),
      static_cast<int32_t*>(counters), t_max, num_heads, hg, chunk,
      stage_rows, scale);
  return cudaGetLastError();
}

}  // namespace

// With NC = ceil(T / chunk) and NG = ceil(NC / 16): partials, B * (NC +
// NG) * H * (D + 4) floats of scratch; counters, B * H * (NG + 1) int32,
// zero before the first launch (every launch leaves them 0).
extern "C" int t2r_decode_tick(const void* q, const void* k_new,
                               const void* v_new, void* k_arena,
                               void* v_arena, const void* slots,
                               const void* index, const void* mask, void* out,
                               void* partials, void* counters, int b,
                               int t_max, int num_heads, int head_dim,
                               int chunk, void* stream) {
  if (b <= 0 || b > 65535 || t_max <= 0 || num_heads <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch<16>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, partials, counters, b, t_max, num_heads, chunk, s); break;
    case 32: err = launch<32>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, partials, counters, b, t_max, num_heads, chunk, s); break;
    case 64: err = launch<64>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, partials, counters, b, t_max, num_heads, chunk, s); break;
    case 128: err = launch<128>(q, k_new, v_new, k_arena, v_arena, slots, index, mask, out, partials, counters, b, t_max, num_heads, chunk, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* t2r_decode_tick_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// kd-tree closest-hit / any-hit traversal for the H100 (sm_90a).
//
// Replaces: dod_raytracer_tpu/ops/pallas/packet_kernel.py, packet_traverse /
// _kernel (the TPU packet megakernel).  Same inputs (the kd node table, the
// per-block Plücker matrices block_g, the per-block vertex AABBs, block_orig,
// rays o, d, t_max), plus the kd tables' block_tris rows, and the same
// outputs (t, prim, found), in closest-hit or any-hit mode.
//
// What bounds it on this card: neither HBM bytes nor fp32 throughput.
// The tables are small (teapot: a few MB) and stay in L2; each ray reads its
// 28 input bytes once and writes 12 bytes.  The work is data-dependent
// pointer chasing: per ray a chain of dependent node loads, then per visited
// leaf block S (<= 384) edge-sign tests of 33 fp32 operations each from
// block_g, and a Möller–Trumbore distance for the few slots whose edge
// signs agree.  Rays
// of one warp that diverge (different nodes, different blocks) serialize,
// so the kernel runs far below both the memory and the fp32 roofline.
//
// Design (simple first; a warp- or CTA-coherent packet walk is later work):
//   * one thread per ray, 128 threads per block;
//   * the reference's per-ray walk (kdtree.cpp:263-361): root slab test,
//     break when the clip falls below the node tmin, near/far order with the
//     origin-on-plane rule, far/near skip rules, a private worklist stack of
//     stack_depth <= 64 entries in local memory;
//   * node rows and block data read through __ldg (read-only path);
//   * at a leaf, each block is first tested against its vertex AABB
//     (padded by a relative 1e-5 so rounding never rejects a real hit; NaN
//     slabs are treated as unbounded), then gets the leaf test of
//     kd_leaf.cuh (shared with kd_walk.cu): the Plücker edge signs on
//     block_g and the Möller–Trumbore distance on block_tris, for the slots
//     that pass them, each fp32 operation rounded on its own;
//   * closest-hit keeps the first strictly smaller t (slot order within a
//     block, visit order across blocks); any-hit exits at its first hit.
//
// C entry point: dod_packet_traverse(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronize.
// Its `stats` and `touched` pointers are for measurement only and null on
// the render path; when `stats` is set, a separate instantiation (kStats)
// writes per ray [interior-node steps, tested blocks, non-empty slots
// edge-tested, slots whose distance was computed], and marks in `touched`
// (B, 2 + slots), when it is set, the blocks whose AABB was read (column
// 0), the blocks edge-tested (column 1) and the slots whose triangle row
// was read: the work and the bytes behind the kernel's least-time bound.

#include "kd_leaf.cuh"

namespace {

using kdleaf::comp;
using kdleaf::kLeafFlag;

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;

struct Tables {
  const float* nodes;   // (M, 5) [flag|split|right|leaf_start|leaf_lanes], ints bit-cast
  const float* bounds;  // (6,) world bounds [min xyz | max xyz]
  const float* aabb;    // (6, B) per-block vertex AABB
  const float* g;       // (B, 16, 5*spad) Plücker matrices
  const float* tris;    // (B, slots, 9) [A | B-A | C-A]
  const int* orig;      // (B, slots) original triangle id, -1 empty
  int num_blocks;
  int slots;
  int spad;
  int block_lanes;
  int stack_depth;
};

// Does the segment (0, clip) of the ray touch block blk's vertex AABB?
__device__ __forceinline__ bool block_may_hit(const Tables& tb, int blk,
                                              const float3& o,
                                              const float3& inv, float clip) {
  const int B = tb.num_blocks;
  float tlo = -INFINITY, thi = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float mn = __ldg(tb.aabb + a * B + blk);
    float mx = __ldg(tb.aabb + (a + 3) * B + blk);
    const float pad = 1e-5f * (fabsf(mn) + fabsf(mx) + 1.0f);
    float t0 = (mn - pad - comp(o, a)) * comp(inv, a);
    float t1 = (mx + pad - comp(o, a)) * comp(inv, a);
    if (isnan(t0) || isnan(t1)) continue;  // origin on a slab face, parallel ray
    tlo = fmaxf(tlo, fminf(t0, t1));
    thi = fminf(thi, fmaxf(t0, t1));
  }
  return !(tlo > thi || thi <= 0.0f || tlo >= clip);
}

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kThreads)
packet_traverse_kernel(Tables tb, const float* __restrict__ o_in,
                       const float* __restrict__ d_in,
                       const float* __restrict__ tmax_in,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       int* __restrict__ found_out, int* __restrict__ stats,
                       int* __restrict__ touched, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float3 o = make_float3(o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]);
  const float3 d = make_float3(d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]);
  const float t_max = tmax_in[i];
  const float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);

  float tmin, tmax;
  bool active = kdleaf::root_slab(tb.bounds, o, inv, t_max, tmin, tmax);
  float r[6];
  kdleaf::plucker_row(o, d, r);
  const size_t blk_stride = 16 * 5 * static_cast<size_t>(tb.spad);

  float t_best = t_max;
  int prim = -1;
  bool found = false;
  int node_steps = 0, blocks_tested = 0, work[2] = {0, 0};
  int stk_node[kMaxStack];
  float stk_tmin[kMaxStack], stk_tmax[kMaxStack];
  int node = 0, sp = 0;

  while (active) {
    const float clip = t_best < t_max ? t_best : t_max;
    if (clip < tmin) break;  // kdtree.cpp:286-289
    const float* nd = tb.nodes + 5 * node;
    const int flag = __float_as_int(__ldg(nd));
    if (flag != kLeafFlag) {  // interior step (kdtree.cpp:290-329)
      if (kStats) ++node_steps;
      const float split = __ldg(nd + 1);
      const int right = __float_as_int(__ldg(nd + 2));
      const int axis = flag < 0 ? 0 : (flag > 2 ? 2 : flag);
      const float o_ax = comp(o, axis), d_ax = comp(d, axis);
      const float t_plane = (split - o_ax) * comp(inv, axis);
      const bool left_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
      const int near_child = left_first ? node + 1 : right;
      const int far_child = left_first ? right : node + 1;
      const bool skip_far = (t_plane > tmax) || (t_plane <= 0.0f);
      const bool skip_near = !skip_far && (t_plane < tmin);
      if (skip_far) {
        node = near_child;
      } else if (skip_near) {
        node = far_child;
      } else {
        const int s = sp < tb.stack_depth - 1 ? sp : tb.stack_depth - 1;
        stk_node[s] = far_child;
        stk_tmin[s] = t_plane;
        stk_tmax[s] = tmax;
        ++sp;
        tmax = t_plane;
        node = near_child;
      }
      continue;
    }

    // leaf: its blocks in order (kdtree.cpp:331-345)
    const int leaf_start = __float_as_int(__ldg(nd + 3));
    const int leaf_lanes = __float_as_int(__ldg(nd + 4));
    bool stop = false;
    for (int cursor = 0; cursor < leaf_lanes; cursor += tb.block_lanes) {
      const float c = t_best < t_max ? t_best : t_max;
      if (c < tmin) { stop = true; break; }
      int blk = (leaf_start + cursor) / tb.block_lanes;
      blk = blk < 0 ? 0 : (blk >= tb.num_blocks ? tb.num_blocks - 1 : blk);
      int* marks = kStats && touched ? touched + static_cast<size_t>(blk) * (2 + tb.slots) : nullptr;
      if (marks) marks[0] = 1;
      if (!block_may_hit(tb, blk, o, inv, c)) continue;
      if (kStats) ++blocks_tested;
      const float* G = tb.g + blk * blk_stride;
      float best = c;
      const int best_j = kdleaf::test_block<kAnyHit, kStats>(
          G, tb.tris + static_cast<size_t>(blk) * tb.slots * 9,
          tb.orig + static_cast<size_t>(blk) * tb.slots, tb.slots, tb.spad, r,
          o, d, best, work, marks);
      if (best_j >= 0) {
        t_best = best;
        prim = __ldg(tb.orig + static_cast<size_t>(blk) * tb.slots + best_j);
        found = true;
        if (kAnyHit) { stop = true; break; }
      }
    }
    if (stop || sp == 0) break;
    // pop the worklist (kdtree.cpp:347-357)
    int s = sp - 1;
    s = s > tb.stack_depth - 1 ? tb.stack_depth - 1 : s;
    node = stk_node[s];
    tmin = stk_tmin[s];
    tmax = stk_tmax[s];
    --sp;
  }

  t_out[i] = t_best;
  prim_out[i] = prim;
  found_out[i] = found ? 1 : 0;
  if (kStats) {
    stats[4 * i] = node_steps;
    stats[4 * i + 1] = blocks_tested;
    stats[4 * i + 2] = work[0];
    stats[4 * i + 3] = work[1];
  }
}

}  // namespace

extern "C" int dod_packet_traverse(
    const void* nodes, const void* bounds, const void* aabb, const void* g,
    const void* tris, const void* orig, const void* o, const void* d, const void* t_max,
    void* t_out, void* prim_out, void* found_out, void* stats, void* touched, int n,
    int num_blocks, int slots, int spad, int block_lanes, int stack_depth,
    int any_hit, void* stream) {
  if (n <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kMaxStack || block_lanes < 1 ||
      num_blocks < 1 || slots < 1 || spad < slots)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables tb{static_cast<const float*>(nodes), static_cast<const float*>(bounds),
            static_cast<const float*>(aabb),  static_cast<const float*>(g),
            static_cast<const float*>(tris),  static_cast<const int*>(orig),
            num_blocks,                       slots,
            spad,                             block_lanes,
            stack_depth};
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = any_hit ? (stats ? packet_traverse_kernel<true, true>
                                 : packet_traverse_kernel<true, false>)
                        : (stats ? packet_traverse_kernel<false, true>
                                 : packet_traverse_kernel<false, false>);
  kernel<<<grid, kThreads, 0, s>>>(
      tb, static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(prim_out), static_cast<int*>(found_out),
      static_cast<int*>(stats), static_cast<int*>(touched), n);
  return static_cast<int>(cudaGetLastError());
}

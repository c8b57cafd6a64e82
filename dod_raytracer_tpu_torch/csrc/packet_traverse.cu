// kd-tree closest-hit / any-hit traversal for the H100 (sm_90a): a
// warp-coherent packet walk with leaf blocks staged in shared memory.
//
// Replaces: dod_raytracer_tpu/ops/pallas/packet_kernel.py, packet_traverse /
// _kernel (the TPU packet megakernel).  Same inputs (the kd node table, the
// per-block Plücker matrices block_g, the per-block vertex AABBs, block_orig,
// rays o, d, t_max), plus the kd tables' block_tris rows, and the same
// outputs (t, prim, found), in closest-hit or any-hit mode.
//
// What bounds it on this card: fp32 operations at best (33 per edge-sign
// test of a slot, PERF.md §6), but in practice the issue rate of the leaf
// tests and the latency of the walk's dependent steps.  The tables do not
// stay in L2 (the flagship block_g is 481 MB), so a block's edge rows
// (27.6 KB at spad = 384) must come from HBM once per packet, not once per
// ray.
//
// Design: the packet walk of kd_warp.cuh (warp_walk_kernel<PacketNodes>,
// shared with the mega and forest walks of kd_walk.cu), which says what it
// does about both limits: a packet is one warp of 32 consecutive rays
// sharing one node cursor and stack; a lane's AABB pre-test and a ballot
// pick the leaf blocks it wants; a wanted block's 18 non-zero edge rows are
// staged in the warp's slot of shared memory by cp.async, so it comes from
// HBM once per packet; the leaf test spreads the (ray, slot) pairs over the
// lanes.  A CTA is 8 warps of one slot each, 221 KB at spad 384, one CTA
// per SM.  On the H100 that was faster on every launch timed than 4 warps
// of a 2-slot ring (the TPU kernel's 2-slot DMA FIFO), which also overlaps
// a copy with the test of the block before: two warps a scheduler hide
// more latency than that overlap saves (PERF.md §6).  The TPU kernel's
// mailbox of recent blocks has no counterpart: the build starts every leaf
// on its own block, so a walk never meets a block twice.
//
// Parity (packet_kernel.py:27-37, tests/test_packet.py:49-63): hit masks
// and any-hit bits equal the per-ray walks', closest-hit t is bit-equal (the
// same distance per slot; the min over a superset of the pruning-correct
// leaves is the same min), and prim may differ only where two triangles'
// Möller–Trumbore t are bit-equal.
//
// The per-ray walk this kernel replaced stays below (packet_traverse_ray_
// kernel, C entry dod_packet_traverse_per_ray): one thread per ray, its own
// stack in local memory, blocks read through __ldg (kd_leaf.cuh
// test_block).  Its kStats build counts the work behind the least-time
// bound (what the rays need, PERF.md §6), and it is the same-call baseline
// of chip_smoke.py; the frame never launches it.
//
// C entry points launch on the given stream and return cudaGetLastError();
// they allocate nothing and do not synchronize.  `stats` is for
// measurement only and null on the render path: for the packet walk a
// separate instantiation (kd_warp.cuh kCount) writes per warp
// [interior-node steps, blocks staged, wanting lanes summed over the
// staged blocks, blocks no lane wanted, distances computed]; for the
// per-ray walk (kStats) per ray [interior-node steps, tested blocks,
// non-empty slots edge-tested, slots whose distance was computed], and it marks in
// `touched` (B, 2 + slots), when set, the blocks whose AABB was read
// (column 0), the blocks edge-tested (column 1) and the slots whose
// triangle row was read.

#include "kd_leaf.cuh"
#include "kd_warp.cuh"

namespace {

using kdleaf::comp;
using kdleaf::kLeafFlag;
using kdwarp::kMaxStack;
using kdwarp::Tables;

// ---------------------------------------------------------------------------
// The per-ray walk that the packet walk replaced: the bound's work counts
// and the same-call baseline.

constexpr int kRayThreads = 128;

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kRayThreads)
packet_traverse_ray_kernel(Tables tb, const float* __restrict__ o_in,
                           const float* __restrict__ d_in,
                           const float* __restrict__ tmax_in,
                           float* __restrict__ t_out, int* __restrict__ prim_out,
                           int* __restrict__ found_out, int* __restrict__ stats,
                           int* __restrict__ touched, int n) {
  const int i = blockIdx.x * kRayThreads + threadIdx.x;
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
      const int blk = kdwarp::PacketNodes::block(tb, leaf_start, cursor);
      int* marks = kStats && touched ? touched + static_cast<size_t>(blk) * (2 + tb.slots) : nullptr;
      if (marks) marks[0] = 1;
      if (!kdwarp::block_may_hit(tb, blk, o, inv, c)) continue;
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

Tables make_tables(const void* nodes, const void* bounds, const void* aabb, const void* g,
                   const void* tris, const void* orig, int num_blocks, int slots, int spad,
                   int block_lanes, int stack_depth) {
  return Tables{static_cast<const float*>(nodes), nullptr,
                static_cast<const float*>(bounds),  static_cast<const float*>(aabb),
                static_cast<const float*>(g),       static_cast<const float*>(tris),
                static_cast<const int*>(orig),      num_blocks,
                slots,                              spad,
                block_lanes,                        stack_depth,
                0,                                  0};
}

}  // namespace

// The packet walk.  Needs slots % 4 == 0, spad % 128 == 0, block_g
// 16-byte aligned, 8 staged blocks within the shared memory of a CTA, and
// a tree no deeper than stack_depth.
extern "C" int dod_packet_traverse(
    const void* nodes, const void* bounds, const void* aabb, const void* g,
    const void* tris, const void* orig, const void* o, const void* d, const void* t_max,
    void* t_out, void* prim_out, void* found_out, void* stats, int n,
    int num_blocks, int slots, int spad, int block_lanes, int stack_depth,
    int any_hit, void* stream) {
  const Tables tb = make_tables(nodes, bounds, aabb, g, tris, orig, num_blocks, slots, spad,
                                block_lanes, stack_depth);
  return kdwarp::launch<kdwarp::PacketNodes>(tb, o, d, t_max, t_out, prim_out, found_out, stats, n,
                                             any_hit != 0, static_cast<cudaStream_t>(stream));
}

// The per-ray walk (baseline and bound counts only).
extern "C" int dod_packet_traverse_per_ray(
    const void* nodes, const void* bounds, const void* aabb, const void* g,
    const void* tris, const void* orig, const void* o, const void* d, const void* t_max,
    void* t_out, void* prim_out, void* found_out, void* stats, void* touched, int n,
    int num_blocks, int slots, int spad, int block_lanes, int stack_depth,
    int any_hit, void* stream) {
  if (n <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kMaxStack || block_lanes < 1 ||
      num_blocks < 1 || slots < 1 || spad < slots)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb = make_tables(nodes, bounds, aabb, g, tris, orig, num_blocks, slots, spad,
                                block_lanes, stack_depth);
  const dim3 grid((n + kRayThreads - 1) / kRayThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = any_hit ? (stats ? packet_traverse_ray_kernel<true, true>
                                 : packet_traverse_ray_kernel<true, false>)
                        : (stats ? packet_traverse_ray_kernel<false, true>
                                 : packet_traverse_ray_kernel<false, false>);
  kernel<<<grid, kRayThreads, 0, s>>>(
      tb, static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(prim_out), static_cast<int*>(found_out),
      static_cast<int*>(stats), static_cast<int*>(touched), n);
  return static_cast<int>(cudaGetLastError());
}

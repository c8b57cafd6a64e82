// kd walks for the H100 (sm_90a) over the mega and forest node tables: the
// warp-coherent packet walk of kd_warp.cuh (the render path), and the
// per-ray walk it replaced (measurement only).
//
// Replaces: dod_raytracer_tpu/ops/pallas/traverse_kernel.py, mega_traverse /
// _kernel (the mega layout), and dod_raytracer_tpu/ops/pallas/forest_kernel.py,
// forest_traverse / _kernel (the forest layout).  Same inputs (node tables,
// rays o, d, t_max, the per-block Plücker matrices block_g, block_orig),
// plus the kd tables' block_tris rows and, for the warp walks, the per-block
// vertex AABBs block_aabb; the same outputs (t, prim, found), in
// closest-hit or any-hit mode.
//
// What bounds it on this card: fp32 operations at best (33 per edge-sign
// test of a non-empty slot and per Möller–Trumbore distance, PERF.md §6),
// but in practice the issue rate of the leaf tests and the latency of the
// walk's dependent node loads.  The node tables are small (teapot 41 rows,
// dragon 7 top rows and 4 treelets of 1,024 rows); the leaf blocks are not
// (dragon: 481 MB of block_g, against a 50 MB L2), so a block's edge rows
// must come from HBM once per packet of rays, not once per ray.
//
// Design: the warp walk (kd_warp.cuh warp_walk_kernel, the one template
// of the packet, mega and forest kernels), instantiated for two layouts:
//   * mega: one table of 6-word rows [flag|split|right|leaf_start|
//     leaf_lanes|block0] (ints bit-cast), ops/mega.py pack_nodes_mega;
//   * forest: the walk starts in the top table (4-word rows [flag|split|
//     right|treelet]); at a super-leaf (flag 4) the warp enters that
//     treelet at local node 0; inside, rows come from the (T, cap, 6)
//     treelet rows and child ids are treelet-local, block ids global.  The
//     warp's table (-1 top, else the treelet) is stored with every stack
//     entry, so a pop restores it.  The TPU's consensus loop (one treelet
//     DMA per 256-ray tile) is a batching device of that machine and is not
//     carried over: node rows are read through __ldg, and the TPU kernels'
//     one-hot MXU row fetch has no counterpart (the mega walk needs no
//     1,024-node gate).
// Against the per-ray walk, what the design does about the bound: the 32
// rays of a warp share one node cursor (one dependent load chain, not 32
// diverging ones); a block's edge rows are staged once per warp in shared
// memory by cp.async (the per-ray walk reads 27.6 KB of block_g per ray and
// block at spad 384); and a per-block AABB pre-test, which the TPU walks
// lack, skips the blocks the rays cannot hit (the per-ray walks edge-test
// 1.7-3.5x the slots of a walk that has one, PERF.md §6).
//
// Parity: the packet rule (kd_warp.cuh): hit masks and any-hit bits equal
// the per-ray walks', closest-hit t bit-equal, prim may differ only where
// two triangles' Möller–Trumbore t are bit-equal.
//
// The per-ray walk (kd_walk_kernel, C entry dod_kd_walk) stays for
// measurement only, as packet_traverse.cu keeps its own: one thread per
// ray, 128 threads a block, a private stack in local memory, each leaf
// block read through __ldg (kd_leaf.cuh test_block), no AABB pre-test.  It
// computes the reference's visit order (kdtree.cpp:263-361) exactly, so it
// gives its plain walk's bits (ops/traverse.py traverse_plain,
// traverse_forest_plain); its forest mode returns to the top table at the
// pop that brings the stack back to its depth on entering the treelet
// (forest_kernel.py's exactness argument).  The frame never launches it.
//
// C entry points launch on the given stream and return cudaGetLastError();
// they allocate nothing and do not synchronize.  `stats` is for
// measurement only and null on the render path: the warp walk's kCount
// build writes per warp the five counts of kd_warp.cuh; the per-ray walk's
// kStats build writes per ray [interior-node steps, tested blocks,
// non-empty slots edge-tested, slots whose distance was computed] and
// marks in `touched` (B, 2 + slots), when it is set, the blocks edge-tested
// (column 1) and the slots whose triangle row was read (column 2 + j);
// column 0 (the AABB reads of the per-ray packet walk) stays 0.

#include "kd_leaf.cuh"
#include "kd_warp.cuh"

namespace {

using kdleaf::comp;
using kdleaf::kLeafFlag;
using kdwarp::kMaxStack;
using kdwarp::kTopLeafFlag;
using kdwarp::Tables;

constexpr int kThreads = 128;
constexpr int kRow = 6;     // words per mega / treelet row
constexpr int kTopRow = 4;  // words per top-table row

// The per-ray walk (measurement only).
template <bool kForest, bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kThreads)
kd_walk_kernel(Tables tb, const float* __restrict__ o_in,
               const float* __restrict__ d_in, const float* __restrict__ tmax_in,
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
  // forest state: in a treelet or in the top table, and the watermark
  bool in_tre = !kForest;
  int sp_enter = 0;
  const float* table = kForest ? nullptr : tb.nodes;  // rows of the current treelet

  while (active) {
    const float clip = t_best < t_max ? t_best : t_max;
    if (clip < tmin) break;  // kdtree.cpp:286-289
    const float* nd = (kForest && !in_tre) ? tb.nodes + kTopRow * node : table + kRow * node;
    const int flag = __float_as_int(__ldg(nd));
    if (kForest && !in_tre && flag == kTopLeafFlag) {  // super-leaf: enter its treelet
      int t = __float_as_int(__ldg(nd + 3));
      t = t < 0 ? 0 : (t >= tb.num_tre ? tb.num_tre - 1 : t);
      table = tb.tre + static_cast<size_t>(t) * tb.cap * kRow;
      node = 0;
      sp_enter = sp;
      in_tre = true;
      continue;
    }
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

    // leaf: one block per round, in cursor order (kdtree.cpp:331-345)
    const int leaf_lanes = __float_as_int(__ldg(nd + 4));
    const int block0 = __float_as_int(__ldg(nd + 5));
    bool stop = false;
    for (int cursor = 0; cursor < leaf_lanes; cursor += tb.block_lanes) {
      const float c = t_best < t_max ? t_best : t_max;
      if (c < tmin) { stop = true; break; }
      int blk = block0 + cursor / tb.block_lanes;
      blk = blk < 0 ? 0 : (blk >= tb.num_blocks ? tb.num_blocks - 1 : blk);
      if (kStats) ++blocks_tested;
      float best = c;
      int* marks = kStats && touched ? touched + static_cast<size_t>(blk) * (2 + tb.slots) : nullptr;
      const int best_j = kdleaf::test_block<kAnyHit, kStats>(
          tb.g + blk * blk_stride, tb.tris + static_cast<size_t>(blk) * tb.slots * 9,
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
    // pop the worklist (kdtree.cpp:347-357); in the forest, the pop at the
    // watermark restores a top-table id and returns the walk to top mode
    if (kForest && sp == sp_enter) in_tre = false;
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

template <bool kForest>
void launch_per_ray(const Tables& tb, bool any_hit, bool with_stats, const float* o,
            const float* d, const float* t_max, float* t_out, int* prim_out,
            int* found_out, int* stats, int* touched, int n, cudaStream_t s) {
  auto kernel = any_hit ? (with_stats ? kd_walk_kernel<kForest, true, true>
                                      : kd_walk_kernel<kForest, true, false>)
                        : (with_stats ? kd_walk_kernel<kForest, false, true>
                                      : kd_walk_kernel<kForest, false, false>);
  const dim3 grid((n + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, s>>>(tb, o, d, t_max, t_out, prim_out, found_out,
                                   stats, touched, n);
}

Tables make_tables(const void* nodes, const void* tre, const void* bounds, const void* aabb,
                   const void* g, const void* tris, const void* orig, int num_blocks, int slots,
                   int spad, int block_lanes, int stack_depth, int num_tre, int cap) {
  return Tables{static_cast<const float*>(nodes), static_cast<const float*>(tre),
                static_cast<const float*>(bounds), static_cast<const float*>(aabb),
                static_cast<const float*>(g),     static_cast<const float*>(tris),
                static_cast<const int*>(orig),    num_blocks,
                slots,                            spad,
                block_lanes,                      stack_depth,
                num_tre,                          cap};
}

}  // namespace

// The warp walks.  nodes: mega (M, 6) rows, or the forest's (Ttop, 4) top
// rows; tre: the forest's (num_tre, cap, 6) treelet rows, null for mega.
// Needs slots % 4 == 0, spad % 128 == 0, block_g 16-byte aligned, 8 staged
// blocks within the shared memory of a CTA, and a tree no deeper than
// stack_depth.
extern "C" int dod_kd_warp_walk(
    const void* nodes, const void* tre, const void* bounds, const void* aabb, const void* g,
    const void* tris, const void* orig, const void* o, const void* d, const void* t_max,
    void* t_out, void* prim_out, void* found_out, void* stats, int n, int num_blocks,
    int slots, int spad, int block_lanes, int stack_depth, int num_tre, int cap, int forest,
    int any_hit, void* stream) {
  if (forest && (tre == nullptr || num_tre < 1 || cap < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb = make_tables(nodes, tre, bounds, aabb, g, tris, orig, num_blocks, slots, spad,
                                block_lanes, stack_depth, num_tre, cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (forest)
    return kdwarp::launch<kdwarp::ForestNodes>(tb, o, d, t_max, t_out, prim_out, found_out, stats,
                                               n, any_hit != 0, s);
  return kdwarp::launch<kdwarp::MegaNodes>(tb, o, d, t_max, t_out, prim_out, found_out, stats, n,
                                           any_hit != 0, s);
}

// The per-ray walks (measurement only); the same tables, without block_aabb.
extern "C" int dod_kd_walk(
    const void* nodes, const void* tre, const void* bounds, const void* g,
    const void* tris, const void* orig, const void* o, const void* d,
    const void* t_max, void* t_out, void* prim_out, void* found_out,
    void* stats, void* touched, int n, int num_blocks, int slots, int spad, int block_lanes,
    int stack_depth, int num_tre, int cap, int forest, int any_hit,
    void* stream) {
  if (n <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kMaxStack || block_lanes < 1 ||
      num_blocks < 1 || slots < 1 || spad < slots ||
      (forest && (tre == nullptr || num_tre < 1 || cap < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb = make_tables(nodes, tre, bounds, nullptr, g, tris, orig, num_blocks, slots,
                                spad, block_lanes, stack_depth, num_tre, cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* of = static_cast<const float*>(o);
  const auto* df = static_cast<const float*>(d);
  const auto* tf = static_cast<const float*>(t_max);
  auto* t_o = static_cast<float*>(t_out);
  auto* p_o = static_cast<int*>(prim_out);
  auto* f_o = static_cast<int*>(found_out);
  auto* st = static_cast<int*>(stats);
  auto* th = static_cast<int*>(touched);
  if (forest)
    launch_per_ray<true>(tb, any_hit != 0, st != nullptr, of, df, tf, t_o, p_o, f_o, st, th, n, s);
  else
    launch_per_ray<false>(tb, any_hit != 0, st != nullptr, of, df, tf, t_o, p_o, f_o, st, th, n, s);
  return static_cast<int>(cudaGetLastError());
}

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
// Design (the TPU kernel's packet walk, fitted to a warp):
//   * a packet is one warp of 32 consecutive rays (the 8x128 screen-block
//     order and the bounce and shadow sorts make them neighbours).  The
//     warp shares one node cursor and one node stack; each lane carries its
//     own [tmin, tmax] per stack level (empty where it does not want that
//     node).  At an interior node each lane applies the reference's
//     per-ray rules (kdtree.cpp:290-329) to its interval, and ballots say
//     whether any lane wants the left or the right child.  The warp visits
//     the union of its rays' nodes, near child first by majority vote:
//     any order gives the same closest hit (packet_kernel.py:27-37);
//   * at a leaf, every lane that still wants the cell (its interval is
//     live and its clip not below it) runs the block's AABB pre-test with
//     its own clip, and a ballot skips the block when no lane wants it.
//     The TPU kernel's mailbox of recent blocks has no counterpart: the
//     build starts every leaf on its own block, so a walk never meets a
//     block twice;
//   * a wanted block's 18 non-zero edge rows (rows 0-5 of sections s0-s2)
//     are copied into the warp's slot of shared memory by cp.async, 16
//     bytes a lane, and tested when the next wanted block is staged or the
//     walk ends, so the copy overlaps the descend steps up to the next
//     wanted block.  A CTA is 8 warps of one slot each, 221 KB at spad 384,
//     one CTA per SM.  On the H100 that was faster on every launch timed
//     than 4 warps of a 2-slot ring (the TPU kernel's 2-slot DMA FIFO),
//     which also overlaps a copy with the test of the block before: two
//     warps a scheduler hide more latency than that overlap saves (PERF.md
//     §6);
//   * the leaf test of a staged block spreads the (ray, slot) pairs over
//     the lanes: for each wanting ray in turn, lane l tests slots 4l..4l+3
//     of every 128, reading 4 slots of a row in one conflict-free 16-byte
//     load, with kd_leaf.cuh edge_signs (the same arithmetic as the per-ray
//     walks).  A slot that passes gets its Möller–Trumbore t from
//     block_tris; a warp reduction picks the smallest (t, slot), which is
//     test_block's "first strictly smaller t in slot order" (any-hit: the
//     first hit slot).  A block wanted by w lanes costs w * spad / 128
//     iterations, not spad, so sparse packets do not pay for idle lanes;
//   * lanes past n and rays that miss the root box (t_max = -1 included)
//     stay in the loop as dead lanes: every collective runs on all 32.
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
// separate instantiation (kStats) writes per warp [interior-node steps,
// blocks staged, wanting lanes summed over the staged blocks, blocks no
// lane wanted, distances computed]; for the per-ray walk
// per ray [interior-node steps, tested blocks, non-empty slots
// edge-tested, slots whose distance was computed], and it marks in
// `touched` (B, 2 + slots), when set, the blocks whose AABB was read
// (column 0), the blocks edge-tested (column 1) and the slots whose
// triangle row was read.

#include "kd_leaf.cuh"

namespace {

using kdleaf::comp;
using kdleaf::kLeafFlag;

constexpr int kMaxStack = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps (packets) a CTA of the packet walk
constexpr int kNoSlot = 0x7fffffff;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)

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

__device__ __forceinline__ int leaf_block(const Tables& tb, int leaf_start, int cursor) {
  const int blk = (leaf_start + cursor) / tb.block_lanes;
  return blk < 0 ? 0 : (blk >= tb.num_blocks ? tb.num_blocks - 1 : blk);
}

// ---------------------------------------------------------------------------
// The packet walk: one warp = one packet of 32 rays.

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float3 shfl3(const float3& v, int src) {
  return make_float3(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src));
}

// Per-warp state of the packet walk.  Warp-uniform: the staged block.
// Per lane: the ray and its running result.
template <bool kAnyHit, bool kStats>
struct Packet {
  Tables tb;
  float* staged;  // the warp's slot: (6, 3, spad) floats
  int lane;
  // the ray
  float3 o, d, inv;
  float r[6];
  float t_max, t_best;
  int prim;
  bool found, done;
  // the block staged and not yet tested (-1: none), and the lanes that wanted it
  int pend_blk;
  unsigned pend_want;
  // kStats counters: [node steps, blocks staged, wanting lanes, blocks no
  // lane wanted, distances]
  int st[5];

  __device__ __forceinline__ float clip() const { return t_best < t_max ? t_best : t_max; }

  // NaN-conservative: a NaN bound keeps the lane alive (packet_kernel.py:42-45)
  __device__ __forceinline__ bool alive(float tn, float tx) const {
    return !done && !(tx < tn) && !(clip() < tn);
  }

  // Test the staged block against the rays that wanted it.
  __device__ __forceinline__ void test_staged() {
    cp_async_wait_all();
    __syncwarp();
    const int blk = pend_blk;
    unsigned want = pend_want & ~__ballot_sync(kFull, done);
    pend_blk = -1;
    if (kStats) st[2] += __popc(want);
    const kdleaf::SharedRows rows{staged, tb.spad};
    const float* tris = tb.tris + static_cast<size_t>(blk) * tb.slots * 9;
    while (want) {
      const int src = __ffs(want) - 1;
      want &= want - 1;
      float rr[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) rr[k] = __shfl_sync(kFull, r[k], src);
      const float3 oo = shfl3(o, src), dd = shfl3(d, src);
      float bt = __shfl_sync(kFull, clip(), src);
      int bj = kNoSlot;
      for (int base = 0; base < tb.slots; base += 128) {
        const int j0 = base + 4 * lane;
        if (j0 < tb.slots) {
          bool inside[4];
          kdleaf::edge_signs<4>(rows, j0, rr, inside);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (!inside[q] || (kAnyHit && bj != kNoSlot)) continue;
            if (kStats) ++st[4];
            const float t = kdleaf::mt_distance(tris + 9 * (j0 + q), oo, dd);
            if (t > 0.0f && t < bt) {
              bt = t;
              bj = j0 + q;
            }
          }
        }
        if (kAnyHit && __any_sync(kFull, bj != kNoSlot)) break;
      }
      // the smallest (t, slot) over the warp; any-hit: the first hit slot
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kFull, bt, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        const bool better = kAnyHit ? oj < bj : (ot < bt || (ot == bt && oj < bj));
        if (better) {
          bt = ot;
          bj = oj;
        }
      }
      if (lane == src && bj != kNoSlot) {
        t_best = bt;
        prim = __ldg(tb.orig + static_cast<size_t>(blk) * tb.slots + bj);
        found = true;
        if (kAnyHit) done = true;
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }

  // Stage block blk for the lanes in `want`, after testing the block
  // staged before it.
  __device__ __forceinline__ void stage(int blk, unsigned want) {
    if (pend_blk >= 0) test_staged();
    float* dst = staged;
    const int spad = tb.spad;
    const float* src = tb.g + static_cast<size_t>(blk) * 16 * 5 * spad;
    const int pieces = 3 * spad / 4;  // 16-byte pieces of one row's s0..s2
#pragma unroll 1
    for (int k = 0; k < 6; ++k)
      for (int p = lane; p < pieces; p += 32)
        cp_async16(dst + k * 3 * spad + 4 * p, src + static_cast<size_t>(k) * 5 * spad + 4 * p);
    cp_async_commit();
    pend_blk = blk;
    pend_want = want;
    if (kStats) ++st[1];
  }
};

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kWarps * 32)
packet_traverse_warp_kernel(Tables tb, const float* __restrict__ o_in,
                            const float* __restrict__ d_in,
                            const float* __restrict__ tmax_in,
                            float* __restrict__ t_out, int* __restrict__ prim_out,
                            int* __restrict__ found_out, int* __restrict__ stats, int n) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int packet_id = blockIdx.x * kWarps + warp;
  const int i = packet_id * 32 + lane;
  const bool valid = i < n;

  Packet<kAnyHit, kStats> P{tb, smem + static_cast<size_t>(warp) * 18 * tb.spad, lane};
  P.o = valid ? make_float3(o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]) : make_float3(0.f, 0.f, 0.f);
  P.d = valid ? make_float3(d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]) : make_float3(0.f, 0.f, 1.f);
  P.t_max = valid ? tmax_in[i] : -1.0f;
  P.inv = make_float3(1.0f / P.d.x, 1.0f / P.d.y, 1.0f / P.d.z);
  kdleaf::plucker_row(P.o, P.d, P.r);
  P.t_best = P.t_max;
  P.prim = -1;
  P.found = false;
  P.pend_blk = -1;
  P.pend_want = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) P.st[s] = 0;

  float tn, tx;
  const bool active = valid && kdleaf::root_slab(tb.bounds, P.o, P.inv, P.t_max, tn, tx);
  P.done = !active;
  if (!active) {
    tn = INFINITY;
    tx = -INFINITY;
  }

  int stk_node[kMaxStack];
  float stk_tn[kMaxStack], stk_tx[kMaxStack];
  int node = 0, sp = 0;
  bool any = __any_sync(kFull, P.alive(tn, tx));

  while (true) {
    if (!any) {  // pop until some lane wants the entry
      while (sp > 0) {
        --sp;
        node = stk_node[sp];
        tn = stk_tn[sp];
        tx = stk_tx[sp];
        if (__any_sync(kFull, P.alive(tn, tx))) {
          any = true;
          break;
        }
      }
      if (!any) break;
    }
    if (kAnyHit && __all_sync(kFull, P.done)) break;
    const float* nd = tb.nodes + 5 * node;
    const int flag = __float_as_int(__ldg(nd));
    if (flag != kLeafFlag) {  // interior step: each lane's rules, then ballots
      if (kStats) ++P.st[0];
      const float split = __ldg(nd + 1);
      const int right = __float_as_int(__ldg(nd + 2));
      const int axis = flag < 0 ? 0 : (flag > 2 ? 2 : flag);
      const bool here = P.alive(tn, tx);
      float tnL = INFINITY, txL = -INFINITY, tnR = INFINITY, txR = -INFINITY;
      bool left_first = false;
      if (here) {
        const float o_ax = comp(P.o, axis), d_ax = comp(P.d, axis);
        const float t_plane = (split - o_ax) * comp(P.inv, axis);
        left_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
        const bool skip_far = (t_plane > tx) || (t_plane <= 0.0f);
        const bool skip_near = !skip_far && (t_plane < tn);
        const bool push = !skip_far && !skip_near;
        const float tn_far = push ? t_plane : tn, tx_near = push ? t_plane : tx;
        if (left_first) {
          if (!skip_near) { tnL = tn; txL = tx_near; }
          if (!skip_far) { tnR = tn_far; txR = tx; }
        } else {
          if (!skip_near) { tnR = tn; txR = tx_near; }
          if (!skip_far) { tnL = tn_far; txL = tx; }
        }
      }
      const unsigned bl = __ballot_sync(kFull, P.alive(tnL, txL));
      const unsigned br = __ballot_sync(kFull, P.alive(tnR, txR));
      const unsigned votes = __ballot_sync(kFull, here && left_first);
      const unsigned voters = __ballot_sync(kFull, here);
      if (bl && br) {
        const bool lf = 2 * __popc(votes) >= __popc(voters);
        const int s = sp < tb.stack_depth ? sp : tb.stack_depth - 1;  // the wrapper sizes the stack
        stk_node[s] = lf ? right : node + 1;
        stk_tn[s] = lf ? tnR : tnL;
        stk_tx[s] = lf ? txR : txL;
        sp = s + 1;
        node = lf ? node + 1 : right;
        tn = lf ? tnL : tnR;
        tx = lf ? txL : txR;
      } else if (bl) {
        node = node + 1;
        tn = tnL;
        tx = txL;
      } else if (br) {
        node = right;
        tn = tnR;
        tx = txR;
      } else {
        any = false;
      }
      continue;
    }

    // leaf: stage its blocks that some lane of the cell wants
    // (kdtree.cpp:331-345; a lane leaves the cell when its clip falls
    // below the cell's tmin, as the per-ray walk stops)
    const int leaf_start = __float_as_int(__ldg(nd + 3));
    const int leaf_lanes = __float_as_int(__ldg(nd + 4));
    for (int cursor = 0; cursor < leaf_lanes; cursor += tb.block_lanes) {
      if (kAnyHit && __all_sync(kFull, P.done)) break;
      const int blk = leaf_block(tb, leaf_start, cursor);
      const unsigned want =
          __ballot_sync(kFull, P.alive(tn, tx) && block_may_hit(tb, blk, P.o, P.inv, P.clip()));
      if (!want) {
        if (kStats) ++P.st[3];
        continue;
      }
      P.stage(blk, want);
    }
    any = false;  // the cell is consumed
  }
  if (P.pend_blk >= 0) P.test_staged();

  if (valid) {
    t_out[i] = P.t_best;
    prim_out[i] = P.prim;
    found_out[i] = P.found ? 1 : 0;
  }
  if (kStats) {
    P.st[4] = __reduce_add_sync(kFull, P.st[4]);  // distances were counted per lane
    if (lane == 0 && packet_id * 32 < n) {
#pragma unroll
      for (int s = 0; s < 5; ++s) stats[5 * packet_id + s] = P.st[s];
    }
  }
}

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
      const int blk = leaf_block(tb, leaf_start, cursor);
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

Tables make_tables(const void* nodes, const void* bounds, const void* aabb, const void* g,
                   const void* tris, const void* orig, int num_blocks, int slots, int spad,
                   int block_lanes, int stack_depth) {
  return Tables{static_cast<const float*>(nodes), static_cast<const float*>(bounds),
                static_cast<const float*>(aabb),  static_cast<const float*>(g),
                static_cast<const float*>(tris),  static_cast<const int*>(orig),
                num_blocks,                       slots,
                spad,                             block_lanes,
                stack_depth};
}

int launch_packet(const Tables& tb, const void* o, const void* d, const void* t_max, void* t_out,
                  void* prim_out, void* found_out, void* stats, int n, int any_hit,
                  cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kWarps) * 18 * tb.spad * sizeof(float);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = any_hit ? (stats ? packet_traverse_warp_kernel<true, true>
                                 : packet_traverse_warp_kernel<true, false>)
                        : (stats ? packet_traverse_warp_kernel<false, true>
                                 : packet_traverse_warp_kernel<false, false>);
  // above 48 KB a launch is refused unless the kernel is allowed more first
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = 32 * kWarps;
  const dim3 grid((n + per_block - 1) / per_block);
  kernel<<<grid, per_block, smem, s>>>(
      tb, static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(prim_out), static_cast<int*>(found_out), static_cast<int*>(stats), n);
  return static_cast<int>(cudaGetLastError());
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
  if (n <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kMaxStack || block_lanes < 1 || num_blocks < 1 ||
      slots < 1 || spad < slots || slots % 4 != 0 || spad % 128 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb = make_tables(nodes, bounds, aabb, g, tris, orig, num_blocks, slots, spad,
                                block_lanes, stack_depth);
  return launch_packet(tb, o, d, t_max, t_out, prim_out, found_out, stats, n, any_hit,
                       static_cast<cudaStream_t>(stream));
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

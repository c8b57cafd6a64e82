// The warp-coherent kd walk shared by the packet, mega and forest kernels
// (packet_traverse.cu, kd_walk.cu): one template over three node-table
// layouts.  Its staging (cp_async16) and its lane-spread leaf test
// (lane_spread_test) also serve the binned walk's block loop
// (block_loop.cu).
//
// A packet is one warp of 32 consecutive rays (the 8x128 screen-block order
// and the bounce and shadow sorts make them neighbours).  The warp shares
// one node cursor and one node stack; each lane carries its own
// [tmin, tmax] per stack level (empty where it does not want that node).
// At an interior node each lane applies the reference's per-ray rules
// (kdtree.cpp:290-329) to its interval, and ballots say whether any lane
// wants the left or the right child.  The warp visits the union of its
// rays' nodes, near child first by majority vote: any order gives the same
// closest hit (packet_kernel.py:27-37).
//
// At a leaf, every lane that still wants the cell (its interval is live and
// its clip not below it) runs the block's AABB pre-test with its own clip,
// and a ballot skips the block when no lane wants it.  The pre-test prunes
// and changes no result: a block whose padded vertex box the segment
// (0, clip) misses holds no hit below clip.  A wanted block's 18 non-zero
// edge rows (rows 0-5 of sections s0-s2 of block_g) are copied into the
// warp's slot of shared memory by cp.async, 16 bytes a lane, and tested
// when the next wanted block is staged or the walk ends, so the copy
// overlaps the descend steps up to the next wanted block.  A CTA is kWarps
// warps of one slot each, 221 KB at spad 384, one CTA per SM.
//
// The leaf test of a staged block spreads the (ray, slot) pairs over the
// lanes: for each wanting ray in turn, lane l tests slots 4l..4l+3 of every
// 128, reading 4 slots of a row in one conflict-free 16-byte load, with
// kd_leaf.cuh edge_signs (the per-ray walks' arithmetic).  A slot that
// passes gets its Möller–Trumbore t from block_tris; a warp reduction picks
// the smallest (t, slot), which is test_block's "first strictly smaller t
// in slot order" (any-hit: the first hit slot).  A block wanted by w lanes
// costs w * spad / 128 iterations, not spad.  Lanes past n and rays that
// miss the root box (t_max = -1 included) stay in the loop as dead lanes:
// every collective runs on all 32.
//
// The node layout is a policy (PacketNodes, MegaNodes, ForestNodes below)
// that answers three questions: the row of node n in table tbl, the
// children of an interior row (split at word 1, right child at word 2, left
// child n + 1 in every layout), and the first block and lane count of a
// leaf row.  The forest's table is warp-uniform, because the warp shares
// one cursor: it is -1 in the top table and the treelet id inside a
// treelet, and every stack entry stores (node, table), so a pop restores
// both.  At a super-leaf (top row flag 4) the warp enters the treelet at
// its local node 0; child ids inside a treelet are local, block ids global.
//
// Parity (packet_kernel.py:27-37, tests/test_packet.py:49-63): hit masks
// and any-hit bits equal the per-ray walks', closest-hit t is bit-equal
// (the same distance per slot; the min over a superset of the
// pruning-correct leaves is the same min), and prim may differ only where
// two triangles' Möller–Trumbore t are bit-equal.
//
// kCount (measurement only) writes per warp [interior-node steps, blocks
// staged, wanting lanes summed over the staged blocks, blocks no lane
// wanted, distances computed].

#pragma once

#include "kd_leaf.cuh"

namespace kdwarp {

using kdleaf::comp;
using kdleaf::kLeafFlag;

constexpr int kMaxStack = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps (packets) a CTA
constexpr int kNoSlot = 0x7fffffff;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int kTopLeafFlag = 4;     // accel/_kdtree_np.py TOP_LEAF_FLAG
constexpr int kStatWords = 5;       // per-warp counts of the kCount build

// Every table a kd walk reads.  nodes: packet (M, 5) rows, mega (M, 6)
// rows, forest (Ttop, 4) top rows; ints bit-cast.
struct Tables {
  const float* nodes;
  const float* tre;     // forest: (T, cap, 6) treelet rows; else null
  const float* bounds;  // (6,) world bounds [min xyz | max xyz]
  const float* aabb;    // (6, B) per-block vertex AABB (null for the per-ray mega/forest walks)
  const float* g;       // (B, 16, 5*spad) Plücker matrices
  const float* tris;    // (B, slots, 9) [A | B-A | C-A]
  const int* orig;      // (B, slots) original triangle id, -1 empty
  int num_blocks;
  int slots;
  int spad;
  int block_lanes;
  int stack_depth;
  int num_tre;
  int cap;
};

__device__ __forceinline__ int clamp_block(const Tables& tb, int blk) {
  return blk < 0 ? 0 : (blk >= tb.num_blocks ? tb.num_blocks - 1 : blk);
}

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

// ---------------------------------------------------------------------------
// Node layouts.  row(tb, tbl, node) -> the row of node `node` in table
// `tbl`; leaf_base(row) -> what block(tb, base, cursor) turns into the
// block that holds lane `cursor` of the leaf.

// packet_traverse.cu: (M, 5) [flag|split|right|leaf_start|leaf_lanes]
struct PacketNodes {
  static constexpr bool kForest = false;
  __device__ __forceinline__ static const float* row(const Tables& tb, int, int node) {
    return tb.nodes + 5 * node;
  }
  __device__ __forceinline__ static int leaf_base(const float* nd) { return __float_as_int(__ldg(nd + 3)); }
  __device__ __forceinline__ static int block(const Tables& tb, int leaf_start, int cursor) {
    return clamp_block(tb, (leaf_start + cursor) / tb.block_lanes);
  }
};

// ops/mega.py pack_nodes_mega: (M, 6) [flag|split|right|leaf_start|leaf_lanes|block0]
struct MegaNodes {
  static constexpr bool kForest = false;
  __device__ __forceinline__ static const float* row(const Tables& tb, int, int node) {
    return tb.nodes + 6 * node;
  }
  __device__ __forceinline__ static int leaf_base(const float* nd) { return __float_as_int(__ldg(nd + 5)); }
  __device__ __forceinline__ static int block(const Tables& tb, int block0, int cursor) {
    return clamp_block(tb, block0 + cursor / tb.block_lanes);
  }
};

// accel/_kdtree_np.py: top rows (Ttop, 4) [flag|split|right|treelet]
// (tbl = -1) and treelet rows (T, cap, 6) as MegaNodes (tbl = treelet id)
struct ForestNodes {
  static constexpr bool kForest = true;
  __device__ __forceinline__ static const float* row(const Tables& tb, int tbl, int node) {
    return tbl < 0 ? tb.nodes + 4 * node : tb.tre + (static_cast<size_t>(tbl) * tb.cap + node) * 6;
  }
  __device__ __forceinline__ static int treelet(const Tables& tb, const float* nd) {
    const int t = __float_as_int(__ldg(nd + 3));
    return t < 0 ? 0 : (t >= tb.num_tre ? tb.num_tre - 1 : t);
  }
  __device__ __forceinline__ static int leaf_base(const float* nd) { return MegaNodes::leaf_base(nd); }
  __device__ __forceinline__ static int block(const Tables& tb, int block0, int cursor) {
    return MegaNodes::block(tb, block0, cursor);
  }
};

// ---------------------------------------------------------------------------
// The packet: one warp.

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

// The lane-spread leaf test of one ray (o, d, its Plücker row r, the same
// in every lane) against a block staged as SharedRows: lane l tests slots
// 4l..4l+3 of every 128 with kdleaf::edge_signs<4>; a slot that passes
// gets its Möller–Trumbore t from `tris` (the block's block_tris rows), and
// `on_distance(slot)` is called for it; a warp reduction picks the smallest
// (t, slot), which is test_block's "first strictly smaller t in slot
// order".  `bt` is the starting bound on entry (the walks: the ray's clip;
// the block loop: inf) and the winner's t on return, in every lane.
// Returns the winning slot, kNoSlot where none is below the bound.
// kStop (any-hit walks): stop at the first hit slot, and return the first
// hit slot, not the closest.
template <bool kStop, class OnDistance>
__device__ __forceinline__ int lane_spread_test(const kdleaf::SharedRows& rows, const float* tris, int slots,
                                                int lane, const float rr[6], const float3& oo,
                                                const float3& dd, float& bt, OnDistance on_distance) {
  int bj = kNoSlot;
  for (int base = 0; base < slots; base += 128) {
    const int j0 = base + 4 * lane;
    if (j0 < slots) {
      bool inside[4];
      kdleaf::edge_signs<4>(rows, j0, rr, inside);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!inside[q] || (kStop && bj != kNoSlot)) continue;
        on_distance(j0 + q);
        const float t = kdleaf::mt_distance(tris + 9 * (j0 + q), oo, dd);
        if (t > 0.0f && t < bt) {
          bt = t;
          bj = j0 + q;
        }
      }
    }
    if (kStop && __any_sync(kFull, bj != kNoSlot)) break;
  }
  // the smallest (t, slot) over the warp; kStop: the first hit slot
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, bt, off);
    const int oj = __shfl_xor_sync(kFull, bj, off);
    const bool better = kStop ? oj < bj : (ot < bt || (ot == bt && oj < bj));
    if (better) {
      bt = ot;
      bj = oj;
    }
  }
  return bj;
}

// Per-warp state of the walk.  Warp-uniform: the staged block.  Per lane:
// the ray and its running result.
template <bool kAnyHit, bool kCount>
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
  // kCount counters: [node steps, blocks staged, wanting lanes, blocks no
  // lane wanted, distances]
  int st[kStatWords];

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
    if (kCount) st[2] += __popc(want);
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
      const int bj = lane_spread_test<kAnyHit>(rows, tris, tb.slots, lane, rr, oo, dd, bt, [&](int) {
        if (kCount) ++st[4];
      });
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
    if (kCount) ++st[1];
  }
};

// ---------------------------------------------------------------------------
// The walk over node layout L: one warp a packet, kWarps packets a CTA,
// each with its slot of 18 * spad floats of dynamic shared memory.

template <class L, bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kWarps * 32)
warp_walk_kernel(Tables tb, const float* __restrict__ o_in, const float* __restrict__ d_in,
                 const float* __restrict__ tmax_in, float* __restrict__ t_out,
                 int* __restrict__ prim_out, int* __restrict__ found_out,
                 int* __restrict__ stats, int n) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int packet_id = blockIdx.x * kWarps + warp;
  const int i = packet_id * 32 + lane;
  const bool valid = i < n;

  Packet<kAnyHit, kCount> P{tb, smem + static_cast<size_t>(warp) * 18 * tb.spad, lane};
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
  for (int s = 0; s < kStatWords; ++s) P.st[s] = 0;

  float tn, tx;
  const bool active = valid && kdleaf::root_slab(tb.bounds, P.o, P.inv, P.t_max, tn, tx);
  P.done = !active;
  if (!active) {
    tn = INFINITY;
    tx = -INFINITY;
  }

  int stk_node[kMaxStack];
  int stk_tbl[L::kForest ? kMaxStack : 1];
  float stk_tn[kMaxStack], stk_tx[kMaxStack];
  // the cursor (node, table): the forest starts in the top table (-1)
  int node = 0, tbl = L::kForest ? -1 : 0, sp = 0;
  bool any = __any_sync(kFull, P.alive(tn, tx));

  while (true) {
    if (!any) {  // pop until some lane wants the entry
      while (sp > 0) {
        --sp;
        node = stk_node[sp];
        if (L::kForest) tbl = stk_tbl[sp];
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
    const float* nd = L::row(tb, tbl, node);
    const int flag = __float_as_int(__ldg(nd));
    if (L::kForest && tbl < 0 && flag == kTopLeafFlag) {  // super-leaf: enter its treelet
      tbl = ForestNodes::treelet(tb, nd);
      node = 0;
      continue;
    }
    if (flag != kLeafFlag) {  // interior step: each lane's rules, then ballots
      if (kCount) ++P.st[0];
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
        if (L::kForest) stk_tbl[s] = tbl;
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
    const int base = L::leaf_base(nd);
    const int leaf_lanes = __float_as_int(__ldg(nd + 4));
    for (int cursor = 0; cursor < leaf_lanes; cursor += tb.block_lanes) {
      if (kAnyHit && __all_sync(kFull, P.done)) break;
      const int blk = L::block(tb, base, cursor);
      const unsigned want =
          __ballot_sync(kFull, P.alive(tn, tx) && block_may_hit(tb, blk, P.o, P.inv, P.clip()));
      if (!want) {
        if (kCount) ++P.st[3];
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
  if (kCount) {
    P.st[4] = __reduce_add_sync(kFull, P.st[4]);  // distances were counted per lane
    if (lane == 0 && packet_id * 32 < n) {
#pragma unroll
      for (int s = 0; s < kStatWords; ++s) stats[kStatWords * packet_id + s] = P.st[s];
    }
  }
}

// Bytes of dynamic shared memory a CTA of the walk takes: kWarps staged blocks.
inline size_t smem_bytes(int spad) { return static_cast<size_t>(kWarps) * 18 * spad * sizeof(float); }

// Whether the tables fit the walk: 4 slots a 16-byte load from 128-slot
// sections, block_g 16-byte aligned, the stack and the staged blocks in
// their limits.
inline bool fits(const Tables& tb) {
  return tb.stack_depth >= 1 && tb.stack_depth <= kMaxStack && tb.block_lanes >= 1 &&
         tb.num_blocks >= 1 && tb.slots >= 1 && tb.spad >= tb.slots && tb.slots % 4 == 0 &&
         tb.spad % 128 == 0 && reinterpret_cast<uintptr_t>(tb.g) % 16 == 0 &&
         smem_bytes(tb.spad) <= static_cast<size_t>(kSmemLimit);
}

// Launch the walk over layout L on n rays (`stats`: null, or the kCount
// build's (ceil(n / 32), kStatWords) counts) -> cudaGetLastError().
template <class L>
int launch(const Tables& tb, const void* o, const void* d, const void* t_max, void* t_out,
           void* prim_out, void* found_out, void* stats, int n, bool any_hit, cudaStream_t s) {
  if (n <= 0) return 0;
  if (!fits(tb)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = any_hit ? (stats ? warp_walk_kernel<L, true, true> : warp_walk_kernel<L, true, false>)
                        : (stats ? warp_walk_kernel<L, false, true> : warp_walk_kernel<L, false, false>);
  const size_t smem = smem_bytes(tb.spad);
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

}  // namespace kdwarp

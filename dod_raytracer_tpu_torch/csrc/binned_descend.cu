// One round of the binned kd walk's descend on the H100 (sm_90a): the
// port's counterpart of the descend phase inside the JAX package's binned
// walk (dod_raytracer_tpu/ops/traverse.py _traverse_binned, the inner
// lax.while_loop of interior_step), which is XLA there and has no Pallas
// kernel.  ops/binned.py binned_traverse launches it once a round, before
// the block-loop kernel (block_loop.cu), so a round is two launches and
// one host read of the active count.
//
// One thread per ray, over every ray of the batch; a ray that is not active
// only writes its key (-1).  For an active ray, in ops/traverse.py _walk's
// order, with _walk's arithmetic and predicates one rounded operation at a
// time (its plain version is ops/binned.py descend_plain):
//   1. fold (every round but the first): the previous round's leaf result
//      (t_leaf, prim_leaf, from the block-loop kernel) where the ray had a
//      block; the cursor advance; the any-hit stop on a hit; the pop or the
//      end of the walk (_walk's leaf phase, after the leaf stage);
//   2. descend to the next leaf (_walk's descend phase);
//   3. write the ray's key, clamp(block0 + cursor / block_lanes, 0, B - 1)
//      where the ray is live and has lanes left in its leaf, else -1;
//   4. count the rays still active into counts[parity] (one atomic a warp).
// Rays are independent, so a ray that descends alone reaches the state it
// reaches in _walk's lockstep loop, and the walk gives traverse_plain's
// bits.  clip is torch.minimum(t_best, t_max), NaN where either is.
//
// What bounds it on this card: bytes.  A round reads each ray's active
// flag and writes its key; an active ray also reads its rays, interval,
// cursor, best hit and last leaf result, and writes its state back, a few
// dozen bytes; the stack entries it pushes and pops come on top.  The
// state lives in device buffers that the wrapper allocates once a walk,
// each (N,) or (depth, N) so that a warp's accesses are coalesced.
//
// C entry point: dod_binned_descend(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not
// synchronize.  Block 0 also sets counts[parity ^ 1] to 0 for the next
// round.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLeafFlag = 3;  // accel/_kdtree_np.py LEAF_FLAG
constexpr unsigned kFull = 0xffffffffu;

// The walk's per-ray state: (N,) arrays, and the (depth, N) stack.
struct State {
  int* node;
  float* tmin;
  float* tmax;
  int* sp;
  int* cursor;
  float* t_best;
  int* prim;
  int* found;
  int* active;
  int* stk_node;
  float* stk_tmin;
  float* stk_tmax;
};

// torch.minimum: NaN where either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

template <bool kAnyHit, bool kFold>
__global__ void __launch_bounds__(kThreads)
descend_kernel(const float* __restrict__ nodes, const float* __restrict__ o_in,
               const float* __restrict__ d_in, const float* __restrict__ inv_in,
               const float* __restrict__ tmax_in, State s, const float* __restrict__ t_leaf,
               const int* __restrict__ prim_leaf, int* __restrict__ keys, int* __restrict__ counts,
               int n, int depth, int block_lanes, int num_blocks, int parity) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[parity ^ 1] = 0;
  bool act = i < n && s.active[i] != 0;
  int key = -1;
  if (act) {
    int node = s.node[i], sp = s.sp[i], cursor = s.cursor[i];
    float tmin = s.tmin[i], tmax = s.tmax[i], t_best = s.t_best[i];
    const float t_max = tmax_in[i];
    const size_t col = static_cast<size_t>(i), stride = static_cast<size_t>(n);
    bool moved = false;  // node, interval, sp or cursor changed

    if (kFold) {  // _walk's leaf phase, after the leaf stage
      const float clip = min_nan(t_best, t_max);
      bool a = !(clip < tmin);
      const int leaf_lanes = __float_as_int(__ldg(nodes + 5 * node + 4));
      bool improved = false;
      if (a && cursor < leaf_lanes) {
        const float tl = t_leaf[i];
        if (tl < clip) {
          t_best = tl;
          s.t_best[i] = tl;
          s.prim[i] = prim_leaf[i];
          s.found[i] = 1;
          improved = true;
        }
      }
      if (a) {
        cursor += block_lanes;
        moved = true;
      }
      bool leaf_done = a && cursor >= leaf_lanes;
      if (kAnyHit) {
        leaf_done = leaf_done && !improved;
        a = a && !improved;
      }
      if (leaf_done && sp > 0) {  // pop
        const size_t e = static_cast<size_t>(clampi(sp - 1, 0, depth - 1)) * stride + col;
        node = s.stk_node[e];
        tmin = s.stk_tmin[e];
        tmax = s.stk_tmax[e];
        sp -= 1;
        cursor = 0;
      } else if (leaf_done) {
        a = false;  // the worklist is empty: the walk ends
      }
      act = a;
    }

    // descend to the next leaf (kdtree.cpp:290-329)
    while (act) {
      const float* nd = nodes + 5 * node;
      const int flag = __float_as_int(__ldg(nd));
      if (!(flag < kLeafFlag)) break;
      const float clip = min_nan(t_best, t_max);
      if (clip < tmin) {  // kdtree.cpp:286-289
        act = false;
        break;
      }
      const float split = __ldg(nd + 1);
      const int right = __float_as_int(__ldg(nd + 2));
      const int axis = clampi(flag, 0, 2);
      const float o_ax = o_in[3 * i + axis], d_ax = d_in[3 * i + axis], inv_ax = inv_in[3 * i + axis];
      const float t_plane = __fmul_rn(__fsub_rn(split, o_ax), inv_ax);
      const bool left_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
      const int near_child = left_first ? node + 1 : right;
      const int far_child = left_first ? right : node + 1;
      const bool skip_far = (t_plane > tmax) || (t_plane <= 0.0f);
      const bool skip_near = !skip_far && (t_plane < tmin);
      if (!skip_far && !skip_near) {  // push the far child
        const size_t e = static_cast<size_t>(clampi(sp, 0, depth - 1)) * stride + col;
        s.stk_node[e] = far_child;
        s.stk_tmin[e] = t_plane;
        s.stk_tmax[e] = tmax;
        sp += 1;
        tmax = t_plane;
      }
      node = skip_near ? far_child : near_child;
      moved = true;
    }

    if (act) {  // the ray's block this round (kdtree.cpp:331-345)
      const float clip = min_nan(t_best, t_max);
      const int leaf_start = __float_as_int(__ldg(nodes + 5 * node + 3));
      const int leaf_lanes = __float_as_int(__ldg(nodes + 5 * node + 4));
      if (!(clip < tmin) && cursor < leaf_lanes)
        key = clampi(leaf_start / block_lanes + cursor / block_lanes, 0, num_blocks - 1);
    }
    if (moved) {
      s.node[i] = node;
      s.tmin[i] = tmin;
      s.tmax[i] = tmax;
      s.sp[i] = sp;
      s.cursor[i] = cursor;
    }
    if (!act) s.active[i] = 0;
  }
  if (i < n) keys[i] = key;
  const unsigned live = __ballot_sync(kFull, act);
  if ((threadIdx.x & 31) == 0 && live) atomicAdd(counts + parity, __popc(live));
}

}  // namespace

// nodes: the (M, 5) rows [flag|split|right|leaf_start|leaf_lanes] of
// ops/traverse.py _pack_nodes; o, d, inv_d (N, 3) and t_max (N,) f32; the
// state arrays as State lists them, int32 or f32; t_leaf, prim_leaf: the
// previous round's block-loop outputs (read only when fold != 0); keys (N,)
// int32 out; counts (2,) int32.
extern "C" int dod_binned_descend(
    const void* nodes, const void* o, const void* d, const void* inv_d, const void* t_max,
    void* node, void* tmin, void* tmax, void* sp, void* cursor, void* t_best, void* prim,
    void* found, void* active, void* stk_node, void* stk_tmin, void* stk_tmax,
    const void* t_leaf, const void* prim_leaf, void* keys, void* counts, int n, int depth,
    int block_lanes, int num_blocks, int fold, int any_hit, int parity, void* stream) {
  if (n <= 0) return 0;
  if (depth < 1 || block_lanes < 1 || num_blocks < 1 || (parity != 0 && parity != 1) ||
      (fold && (t_leaf == nullptr || prim_leaf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const State s{static_cast<int*>(node),    static_cast<float*>(tmin),    static_cast<float*>(tmax),
                static_cast<int*>(sp),      static_cast<int*>(cursor),    static_cast<float*>(t_best),
                static_cast<int*>(prim),    static_cast<int*>(found),     static_cast<int*>(active),
                static_cast<int*>(stk_node), static_cast<float*>(stk_tmin), static_cast<float*>(stk_tmax)};
  auto kernel = any_hit ? (fold ? descend_kernel<true, true> : descend_kernel<true, false>)
                        : (fold ? descend_kernel<false, true> : descend_kernel<false, false>);
  const dim3 grid((n + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodes), static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(inv_d), static_cast<const float*>(t_max), s,
      static_cast<const float*>(t_leaf), static_cast<const int*>(prim_leaf), static_cast<int*>(keys),
      static_cast<int*>(counts), n, depth, block_lanes, num_blocks, parity);
  return static_cast<int>(cudaGetLastError());
}

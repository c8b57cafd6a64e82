// kd-tree closest-hit / any-hit traversal for the H100 (sm_90a).
//
// Replaces: dod_raytracer_tpu/ops/pallas/packet_kernel.py, packet_traverse /
// _kernel (the TPU packet megakernel).  Same inputs (the kd node table, the
// per-block Plücker matrices block_g, the per-block vertex AABBs, block_orig,
// rays o, d, t_max), plus the kd tables' block_tris rows, and the same
// outputs (t, prim, found), in closest-hit or any-hit mode.
//
// What bounds it on this card: neither HBM bytes nor fp32 FMA throughput.
// The tables are small (teapot: a few MB) and stay in L2; each ray reads its
// 28 input bytes once and writes 12 bytes.  The work is data-dependent
// pointer chasing: per ray a chain of dependent node loads, then per visited
// leaf block S (<= 384) edge-sign tests of 18 FMAs each from block_g, and a
// Möller–Trumbore distance for the few slots whose edge signs agree.  Rays
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
//     slabs are treated as unbounded), then every slot gets the Plücker
//     edge-sign test on block_g's columns in fp32 FMA — no TF32 and no tensor
//     cores (fp32 geometry must not pass through reduced-precision products,
//     forest_kernel.py:35-38);
//   * a slot that passes the edge test gets its distance from the Möller–
//     Trumbore expressions on block_tris [A | B-A | C-A], in the plain walk's
//     operation order and without contraction (__fmul_rn / __fadd_rn), so the
//     kernel and the plain walk agree on t and on the sign of t.  The Plücker
//     distance num/den with the packed constant n.A (what the TPU kernel
//     uses) has an absolute error of about ulp(n.A)/|n.d|: for secondary
//     rays, which start 1e-4 off a surface, that flips grazing self-hits;
//   * closest-hit keeps the first strictly smaller t (slot order within a
//     block, visit order across blocks); any-hit exits at its first hit.
//
// block_g layout (accel/kdtree.py pack_block_g): (B, 16, 5*spad) f32, five
// spad-wide sections [s0|s1|s2|den|num] against the ray vector
// [d, o x d, o, 1, 0 x 6].  Only rows 0-5 of the edge sections s0..s2 are
// non-zero there, and only those are read.  Empty slots have all-zero
// columns: no sign test passes on them.
//
// C entry point: dod_packet_traverse(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronize.
// Its `stats` pointer is for measurement only and is null on the render
// path; when it is set, a separate instantiation (kStats) writes per ray
// [interior-node steps, tested blocks, non-empty slots edge-tested], the
// work count behind the kernel's least-time bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;
constexpr int kLeafFlag = 3;

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

__device__ __forceinline__ float comp(const float3& v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
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

// Möller–Trumbore t of one slot (triangle.py mt_t_edges): the same
// expressions in the same order, each operation rounded on its own.
__device__ __forceinline__ float mt_distance(const float* tri, const float3& o,
                                             const float3& d) {
  const float ax = __ldg(tri), ay = __ldg(tri + 1), az = __ldg(tri + 2);
  const float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
  const float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
  // pvec = d x e2; det = pvec . e1
  const float px = __fsub_rn(__fmul_rn(d.y, e2z), __fmul_rn(d.z, e2y));
  const float py = __fsub_rn(__fmul_rn(d.z, e2x), __fmul_rn(d.x, e2z));
  const float pz = __fsub_rn(__fmul_rn(d.x, e2y), __fmul_rn(d.y, e2x));
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(px, e1x), __fmul_rn(py, e1y)), __fmul_rn(pz, e1z));
  if (!(fabsf(det) > 0.0f)) return NAN;
  const float inv_det = __fdiv_rn(1.0f, det);
  // qvec = (o - A) x e1; t = (e2 . qvec) / det
  const float tx = __fsub_rn(o.x, ax), ty = __fsub_rn(o.y, ay), tz = __fsub_rn(o.z, az);
  const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
  const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
  const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)), __fmul_rn(e2z, qz));
  return __fmul_rn(dot, inv_det);
}

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kThreads)
packet_traverse_kernel(Tables tb, const float* __restrict__ o_in,
                       const float* __restrict__ d_in,
                       const float* __restrict__ tmax_in,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       int* __restrict__ found_out, int* __restrict__ stats,
                       int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float3 o = make_float3(o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]);
  const float3 d = make_float3(d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]);
  const float t_max = tmax_in[i];
  const float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);

  // root slab test (box.cpp:33-53; NaN comparisons skip a slab)
  float tmin = 0.0f, tmax = t_max;
  bool active = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float tn = (__ldg(tb.bounds + a) - comp(o, a)) * comp(inv, a);
    float tf = (__ldg(tb.bounds + 3 + a) - comp(o, a)) * comp(inv, a);
    if (tn > tf) { float s = tn; tn = tf; tf = s; }
    if (tn > tmin) tmin = tn;
    if (tf < tmax) tmax = tf;
    active = active && !(tmin > tmax);
  }
  active = active && !(tmin > t_max);  // kdtree.cpp:274

  // ray row [d, o x d] of the Plücker edge products
  const float r[6] = {d.x, d.y, d.z,
                      o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z,
                      o.x * d.y - o.y * d.x};
  const size_t row = 5 * static_cast<size_t>(tb.spad);
  const size_t blk_stride = 16 * row;

  float t_best = t_max;
  int prim = -1;
  bool found = false;
  int node_steps = 0, blocks_tested = 0, slots_tested = 0;
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
      if (!block_may_hit(tb, blk, o, inv, c)) continue;
      if (kStats) ++blocks_tested;
      const float* G = tb.g + blk * blk_stride;
      float best = c;
      int best_j = -1;
      const float* tris = tb.tris + static_cast<size_t>(blk) * tb.slots * 9;
      const int* orig = tb.orig + static_cast<size_t>(blk) * tb.slots;
      for (int j = 0; j < tb.slots; ++j) {
        if (kStats) slots_tested += __ldg(orig + j) >= 0;
        // Plücker edge signs: s_k = d . (column rows 0-2) + (o x d) . (rows 3-5)
        const float* col = G + j;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float* rk = col + k * row;
          s0 = fmaf(r[k], __ldg(rk), s0);
          s1 = fmaf(r[k], __ldg(rk + tb.spad), s1);
          s2 = fmaf(r[k], __ldg(rk + 2 * tb.spad), s2);
        }
        const bool inside = (s0 > 0.0f && s1 > 0.0f && s2 > 0.0f) ||
                            (s0 < 0.0f && s1 < 0.0f && s2 < 0.0f);
        if (!inside) continue;
        const float t = mt_distance(tris + 9 * j, o, d);
        if (t > 0.0f && t < best) {
          best = t;
          best_j = j;
          if (kAnyHit) break;
        }
      }
      if (best_j >= 0) {
        t_best = best;
        prim = __ldg(orig + best_j);
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
    stats[3 * i] = node_steps;
    stats[3 * i + 1] = blocks_tested;
    stats[3 * i + 2] = slots_tested;
  }
}

}  // namespace

extern "C" int dod_packet_traverse(
    const void* nodes, const void* bounds, const void* aabb, const void* g,
    const void* tris, const void* orig, const void* o, const void* d, const void* t_max,
    void* t_out, void* prim_out, void* found_out, void* stats, int n,
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
      static_cast<int*>(stats), n);
  return static_cast<int>(cudaGetLastError());
}

// Leaf-block test shared by the kd traversal kernels (packet_traverse.cu,
// kd_walk.cu, block_loop.cu): the Plücker edge-sign test on block_g, then the
// Möller–Trumbore distance on block_tris for the slots that pass it.  The
// plain walks (ops/traverse.py, with ops/triangle.py plucker_row,
// plucker_inside and mt_t_edges) compute the same test operation by
// operation, so a kernel and its plain version give the same bits.
//
// block_g layout (accel/kdtree.py pack_block_g): (B, 16, 5*spad) f32, five
// spad-wide sections [s0|s1|s2|den|num] against the ray vector
// [d, o x d, o, 1, 0 x 6].  Only rows 0-5 of the edge sections s0..s2 are
// non-zero there, and only those are read.  Empty slots have all-zero
// columns: no sign test passes on them.
//
// The distance is not the Plücker num/den of the TPU kernels: with the
// packed constant n.A its absolute error is about ulp(n.A)/|n.d|, which
// flips grazing self-hits of secondary rays (they start 1e-4 off a
// surface).  Möller–Trumbore on block_tris [A | B-A | C-A], in the plain
// walk's operation order and without contraction (__fmul_rn / __fadd_rn),
// gives the kernels and the plain walk (ops/triangle.py mt_t_edges) the
// same t and the same sign of t.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kdleaf {

constexpr int kLeafFlag = 3;

__device__ __forceinline__ float comp(const float3& v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

// The ray row [d, o x d] of the Plücker edge products, each operation
// rounded on its own (triangle.py plucker_row).
__device__ __forceinline__ void plucker_row(const float3& o, const float3& d,
                                            float r[6]) {
  r[0] = d.x;
  r[1] = d.y;
  r[2] = d.z;
  r[3] = __fsub_rn(__fmul_rn(o.y, d.z), __fmul_rn(o.z, d.y));
  r[4] = __fsub_rn(__fmul_rn(o.z, d.x), __fmul_rn(o.x, d.z));
  r[5] = __fsub_rn(__fmul_rn(o.x, d.y), __fmul_rn(o.y, d.x));
}

// Root slab test against the world bounds (box.cpp:33-53; NaN comparisons
// skip a slab) -> whether the ray is live, and its [tmin, tmax].
__device__ __forceinline__ bool root_slab(const float* bounds, const float3& o,
                                          const float3& inv, float t_max,
                                          float& tmin, float& tmax) {
  tmin = 0.0f;
  tmax = t_max;
  bool active = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float tn = (__ldg(bounds + a) - comp(o, a)) * comp(inv, a);
    float tf = (__ldg(bounds + 3 + a) - comp(o, a)) * comp(inv, a);
    if (tn > tf) { float s = tn; tn = tf; tf = s; }
    if (tn > tmin) tmin = tn;
    if (tf < tmax) tmax = tf;
    active = active && !(tmin > tmax);
  }
  return active && !(tmin > t_max);  // kdtree.cpp:274
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

// Where a block's edge rows come from: rows 0-5 of sections s0..s2 of
// block_g.  `load(k, e, j, v)` fills v[0..W) with row k, section e, slots
// j..j+W-1.
//
// GlobalRows reads one block of block_g (B, 16, 5*spad) through __ldg
// (the per-ray walks).  SharedRows reads a block staged in shared memory
// as [k][e][spad] (the packet walk, packet_traverse.cu): 18 rows of spad
// floats, 16-byte aligned, so W = 4 slots come in one 16-byte load.
struct GlobalRows {
  const float* g;  // the block's (16, 5*spad) rows
  int spad;
  template <int W>
  __device__ __forceinline__ void load(int k, int e, int j, float (&v)[W]) const {
    const float* p = g + static_cast<size_t>(k) * 5 * spad + e * spad + j;
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = __ldg(p + w);
  }
};

struct SharedRows {
  const float* s;  // (6, 3, spad) staged rows
  int spad;
  template <int W>
  __device__ __forceinline__ void load(int k, int e, int j, float (&v)[W]) const {
    static_assert(W == 4, "staged rows are read 4 slots at a time");
    const float4 x = *reinterpret_cast<const float4*>(s + (k * 3 + e) * spad + j);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};

// Plücker edge signs of W consecutive slots j..j+W-1: each sign
// r . column summed in row order with every product and sum rounded on its
// own (triangle.py plucker_inside; no FMA contraction, no TF32: fp32
// geometry must not pass through fused or reduced-precision products,
// forest_kernel.py:35-38).  inside[w]: the three signs all > 0 or all < 0.
template <int W, class Rows>
__device__ __forceinline__ void edge_signs(const Rows& g, int j, const float r[6],
                                           bool (&inside)[W]) {
  float s0[W], s1[W], s2[W], v[W];
  // s_e = d . (column rows 0-2) + (o x d) . (rows 3-5)
  g.load(0, 0, j, v);
#pragma unroll
  for (int w = 0; w < W; ++w) s0[w] = __fmul_rn(r[0], v[w]);
  g.load(0, 1, j, v);
#pragma unroll
  for (int w = 0; w < W; ++w) s1[w] = __fmul_rn(r[0], v[w]);
  g.load(0, 2, j, v);
#pragma unroll
  for (int w = 0; w < W; ++w) s2[w] = __fmul_rn(r[0], v[w]);
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    g.load(k, 0, j, v);
#pragma unroll
    for (int w = 0; w < W; ++w) s0[w] = __fadd_rn(s0[w], __fmul_rn(r[k], v[w]));
    g.load(k, 1, j, v);
#pragma unroll
    for (int w = 0; w < W; ++w) s1[w] = __fadd_rn(s1[w], __fmul_rn(r[k], v[w]));
    g.load(k, 2, j, v);
#pragma unroll
    for (int w = 0; w < W; ++w) s2[w] = __fadd_rn(s2[w], __fmul_rn(r[k], v[w]));
  }
#pragma unroll
  for (int w = 0; w < W; ++w)
    inside[w] = (s0[w] > 0.0f && s1[w] > 0.0f && s2[w] > 0.0f) ||
                (s0[w] < 0.0f && s1[w] < 0.0f && s2[w] < 0.0f);
}

// One leaf block read from global memory: every slot in order gets the
// edge-sign test (edge_signs); a slot that passes gets its
// Möller–Trumbore t.  Closest-hit keeps the first strictly smaller t in
// slot order; any-hit returns at the first hit.  Returns the winning slot
// (-1: none) and lowers `best` to its t.
//
// With kStats (measurement only), `work` counts [non-empty slots whose edge
// signs were tested, slots whose t was computed], and `touched`, when set,
// is this block's row of the (B, 2 + slots) marks: column 1 the block was
// edge-tested, column 2 + j slot j's triangle row was read.
template <bool kAnyHit, bool kStats>
__device__ __forceinline__ int test_block(const float* G, const float* tris,
                                          const int* orig, int slots, int spad,
                                          const float r[6], const float3& o,
                                          const float3& d, float& best,
                                          int work[2], int* touched) {
  if (kStats && touched) touched[1] = 1;
  const GlobalRows rows{G, spad};
  int best_j = -1;
  for (int j = 0; j < slots; ++j) {
    if (kStats) work[0] += __ldg(orig + j) >= 0;
    bool inside[1];
    edge_signs<1>(rows, j, r, inside);
    if (!inside[0]) continue;
    if (kStats) {
      ++work[1];
      if (touched) touched[2 + j] = 1;
    }
    const float t = mt_distance(tris + 9 * j, o, d);
    if (t > 0.0f && t < best) {
      best = t;
      best_j = j;
      if (kAnyHit) break;
    }
  }
  return best_j;
}

}  // namespace kdleaf

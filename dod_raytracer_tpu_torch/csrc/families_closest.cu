// Closest hit of a wavefront against the sphere, plane and cylinder families
// on the H100 (sm_90a).  It replaces no TPU kernel: the JAX package computes
// these tests in XLA (dod_raytracer_tpu/intersect.py closest_hit's family
// chain).  The port's plain version is ops/families.py closest_plain: the
// winner choice winner_plain (ops/sphere.py sphere_winner, ops/plane.py
// plane_winner, ops/cylinder.py cylinder_winner: all-pairs candidates,
// argmins) then the winner's recompute hit_of (sphere_hit, plane_hit,
// cylinder_hit), which writes and rereads (N, S, 3) float intermediates in
// some 340 launches; this kernel keeps every intermediate in registers, in
// one launch.
//
// One thread per ray.  Each CTA stages the family tables in shared memory,
// in chunks of at most kSpheres / kPlanes / kCylinders rows, read straight
// from the scene's tensors: any count of each family works.  The
// ray-independent terms are computed once at staging, as the torch version
// computes them (radius * radius; the cap centres base + axis * 0 and
// base + axis * height).  A ray keeps its running closest t, starting at
// t_max, and a candidate replaces it only when strictly smaller: within a
// family that is the first of equal candidates (argmin's first
// occurrence, then t < clip), across families the reference's chain (a
// later family wins only on a strictly smaller t, each family clipped at
// minimum(best t, t_max)).  The torch version recomputes the winner's t
// from its gathered row with the operations that made its candidate, so
// the recomputed t is the candidate's bit for bit and the kernel keeps the
// candidate's.  Then the winner's row is read again from the tables for
// its normal and colour.  A ray whose t_max cannot admit a hit (t_max <= 0
// or NaN, with eps >= 0) writes a miss without loading its ray, and a CTA
// none of whose rays is left skips the tables.
//
// Same bits as the plain version on the card: each expression is the torch
// version's, in its order, one rounded operation at a time (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn; no contraction into FMAs;
// torch.rsqrt on CUDA is rsqrtf).  A torch.sum over a last dimension of 3
// on CUDA gives (x0 + x2) + x1 (sum3; see families_any.cu).  The sphere's
// min(t0, t1) is t0: thc >= 0 and rounding is monotone.  The predicates are
// the torch version's, as in families_any.cu, with each candidate's t
// compared strictly with the running closest t.
//
// Outputs a ray: t (+inf on a miss), the normal (the sphere's normalized
// hit point minus centre, the plane's stored normal unflipped, the
// cylinder body's normalized radial vector or the cap's -axis / axis by
// the sign of d . axis), the colour (zero for cylinders under color_bug)
// and one int32 winner: -1 on a miss, else row << 4 | kind << 2 | family
// (family 0 sphere, 1 plane, 2 cylinder; kind 0 body, 1 cap at the base,
// 2 cap at the top, 0 for spheres and planes).  A miss writes zeros for
// its normal and colour.
//
// What bounds it on this card: bytes.  A ray reads its origin, direction
// and t_max (28 B) and writes t, normal, colour and winner (32 B): 60 B a
// ray, 62.2 MB at a 1,036,800-ray tile, 0.019 ms at 3.35 TB/s.  Its fp32
// operations, about 500 a ray (16 spheres, 6 planes, one cylinder), take
// 0.008 ms there at 67 TFLOP/s.
//
// C entry point: dod_families_closest(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not
// synchronize.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpheres = 256;   // sphere rows staged per chunk
constexpr int kPlanes = 128;    // plane rows staged per chunk
constexpr int kCylinders = 64;  // cylinder rows staged per chunk

// torch.sum(x, dim=-1) of a (..., 3) float tensor on CUDA.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(x0, x2), x1);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return sum3(__fmul_rn(ax, bx), __fmul_rn(ay, by), __fmul_rn(az, bz));
}

// ops/sphere.py sphere_candidate_t for one sphere (c: centre, w: r * r):
// its t, or +inf.
__device__ __forceinline__ float sphere_t(const float4 c, const float3& o, const float3& d) {
  const float lx = __fsub_rn(c.x, o.x), ly = __fsub_rn(c.y, o.y), lz = __fsub_rn(c.z, o.z);
  const float dist_sq = dot3(lx, ly, lz, lx, ly, lz);
  const float tca = dot3(lx, ly, lz, d.x, d.y, d.z);
  const float d2 = __fsub_rn(dist_sq, __fmul_rn(tca, tca));
  if (!(dist_sq > c.w) || !(d2 < c.w)) return INFINITY;
  const float x = __fsub_rn(c.w, d2);
  const float thc = x > 0.0f ? __fsqrt_rn(x) : 0.0f;  // utils/math.py safe_sqrt
  const float t0 = __fsub_rn(tca, thc), t1 = __fadd_rn(tca, thc);
  return t0 >= 0.0f && t1 >= 0.0f ? t0 : INFINITY;
}

// ops/plane.py plane_candidate_t for one plane (p: point, n: normal).
__device__ __forceinline__ float plane_t(const float4 p, const float4 n, const float3& o, const float3& d,
                                         float eps) {
  const float denom = dot3(d.x, d.y, d.z, n.x, n.y, n.z);
  if (!(fabsf(denom) > eps)) return INFINITY;
  const float num = dot3(__fsub_rn(p.x, o.x), __fsub_rn(p.y, o.y), __fsub_rn(p.z, o.z), n.x, n.y, n.z);
  const float t = __fdiv_rn(num, denom);
  return t > eps ? t : INFINITY;
}

// One cap of ops/cylinder.py cylinder_candidate_t (disc_t), centre c, under
// the clip: its t, or +inf.
__device__ __forceinline__ float cap_t(const float4 c, const float4 ax, const float r_sq, const float d_dot_a,
                                       const float3& o, const float3& d, float clip, float eps) {
  if (!(fabsf(d_dot_a) >= eps)) return INFINITY;
  const float num = dot3(__fsub_rn(c.x, o.x), __fsub_rn(c.y, o.y), __fsub_rn(c.z, o.z), ax.x, ax.y, ax.z);
  const float t = __fdiv_rn(num, d_dot_a);
  if (!(t >= eps) || !(t <= clip)) return INFINITY;
  const float qx = __fsub_rn(__fadd_rn(o.x, __fmul_rn(d.x, t)), c.x);
  const float qy = __fsub_rn(__fadd_rn(o.y, __fmul_rn(d.y, t)), c.y);
  const float qz = __fsub_rn(__fadd_rn(o.z, __fmul_rn(d.z, t)), c.z);
  return dot3(qx, qy, qz, qx, qy, qz) <= r_sq ? t : INFINITY;
}

// The body of ops/cylinder.py cylinder_candidate_t for one cylinder (b: base
// and r * r; ax: axis and height): its t, or +inf.
__device__ __forceinline__ float body_t(const float4 b, const float4 ax, const float d_dot_a, const float3& o,
                                        const float3& d, float eps) {
  const float px = __fsub_rn(o.x, b.x), py = __fsub_rn(o.y, b.y), pz = __fsub_rn(o.z, b.z);
  const float vx = __fsub_rn(d.x, __fmul_rn(d_dot_a, ax.x));
  const float vy = __fsub_rn(d.y, __fmul_rn(d_dot_a, ax.y));
  const float vz = __fsub_rn(d.z, __fmul_rn(d_dot_a, ax.z));
  const float dp_dot_a = dot3(px, py, pz, ax.x, ax.y, ax.z);
  const float qx = __fsub_rn(px, __fmul_rn(dp_dot_a, ax.x));
  const float qy = __fsub_rn(py, __fmul_rn(dp_dot_a, ax.y));
  const float qz = __fsub_rn(pz, __fmul_rn(dp_dot_a, ax.z));
  const float a = dot3(vx, vy, vz, vx, vy, vz);
  const float bb = __fmul_rn(2.0f, dot3(vx, vy, vz, qx, qy, qz));
  const float c = __fsub_rn(dot3(qx, qy, qz, qx, qy, qz), b.w);
  const float disc = __fsub_rn(__fmul_rn(bb, bb), __fmul_rn(__fmul_rn(4.0f, a), c));
  if (!(disc >= eps) || !(a != 0.0f)) return INFINITY;
  const float sq = disc > 0.0f ? __fsqrt_rn(disc) : 0.0f;
  const float inv_2a = __fdiv_rn(1.0f, __fmul_rn(2.0f, a));
  const float t_sub = __fmul_rn(__fsub_rn(-bb, sq), inv_2a);
  const float t_add = __fmul_rn(__fadd_rn(-bb, sq), inv_2a);
  // minNonNegative (cylinder.cpp:8-26); torch.minimum propagates NaN
  float t;
  if (t_sub < 0.0f && t_add < 0.0f) t = INFINITY;
  else if (t_sub < 0.0f) t = t_add;
  else if (t_add < 0.0f) t = t_sub;
  else t = (isnan(t_sub) || isnan(t_add)) ? NAN : fminf(t_sub, t_add);
  if (!isfinite(t)) return INFINITY;
  const float hx = __fsub_rn(__fadd_rn(o.x, __fmul_rn(d.x, t)), b.x);
  const float hy = __fsub_rn(__fadd_rn(o.y, __fmul_rn(d.y, t)), b.y);
  const float hz = __fsub_rn(__fadd_rn(o.z, __fmul_rn(d.z, t)), b.z);
  const float axis_factor = dot3(hx, hy, hz, ax.x, ax.y, ax.z);
  return axis_factor >= 0.0f && axis_factor <= ax.w ? t : INFINITY;
}

__device__ __forceinline__ float3 load3(const float* __restrict__ p, int row) {
  p += 3 * static_cast<size_t>(row);
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

__device__ __forceinline__ void store3(float* __restrict__ p, int row, const float3 v) {
  p += 3 * static_cast<size_t>(row);
  p[0] = v.x, p[1] = v.y, p[2] = v.z;
}

// v * rsqrt(max(v . v, 1e-30)): the torch version's normalization
// (clamp_min, rsqrt, one product a component).
__device__ __forceinline__ float3 normalized(float x, float y, float z) {
  const float r = rsqrtf(fmaxf(dot3(x, y, z, x, y, z), 1e-30f));
  return make_float3(__fmul_rn(x, r), __fmul_rn(y, r), __fmul_rn(z, r));
}

__global__ void __launch_bounds__(kThreads) families_closest_hit_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_max,
    const float* __restrict__ sph_center, const float* __restrict__ sph_radius,
    const float* __restrict__ sph_color, const float* __restrict__ pl_point,
    const float* __restrict__ pl_normal, const float* __restrict__ pl_color,
    const float* __restrict__ cyl_base, const float* __restrict__ cyl_axis,
    const float* __restrict__ cyl_radius, const float* __restrict__ cyl_height,
    const float* __restrict__ cyl_color, float* __restrict__ t_out, float* __restrict__ normal_out,
    float* __restrict__ color_out, int* __restrict__ winner_out, int n, int n_sph, int n_pl, int n_cyl,
    float eps, int color_bug) {
  __shared__ float4 s_sph[kSpheres];         // centre, r * r
  __shared__ float4 s_pl[2 * kPlanes];       // point, normal
  __shared__ float4 s_cyl[4 * kCylinders];   // base and r * r, axis and height, cap centres

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int tid = threadIdx.x;
  float3 ro = make_float3(0.0f, 0.0f, 0.0f), rd = ro;
  float best = 0.0f;  // the running closest t: t_max, then each winner's t
  bool live = false;  // a hit is possible
  if (i < n) {
    best = __ldg(t_max + i);
    live = !(eps >= 0.0f) || best > 0.0f;
    if (live) {
      ro = load3(o, i);
      rd = load3(d, i);
    }
  }
  int winner = -1;

  // each chunk begins with a barrier that also tells whether any ray of the
  // CTA is live: if none is, the CTA skips the tables
  for (int base = 0; base < n_sph; base += kSpheres) {
    if (!__syncthreads_or(live)) goto done;
    const int m = min(kSpheres, n_sph - base);
    for (int j = tid; j < m; j += kThreads) {
      const float r = __ldg(sph_radius + base + j);
      const float3 c = load3(sph_center, base + j);
      s_sph[j] = make_float4(c.x, c.y, c.z, __fmul_rn(r, r));
    }
    __syncthreads();
    if (live)
      for (int j = 0; j < m; ++j) {
        const float t = sphere_t(s_sph[j], ro, rd);
        if (t < best) best = t, winner = (base + j) << 4;
      }
  }
  for (int base = 0; base < n_pl; base += kPlanes) {
    if (!__syncthreads_or(live)) goto done;
    const int m = min(kPlanes, n_pl - base);
    for (int j = tid; j < m; j += kThreads) {
      const float3 p = load3(pl_point, base + j), q = load3(pl_normal, base + j);
      s_pl[2 * j] = make_float4(p.x, p.y, p.z, 0.0f);
      s_pl[2 * j + 1] = make_float4(q.x, q.y, q.z, 0.0f);
    }
    __syncthreads();
    if (live)
      for (int j = 0; j < m; ++j) {
        const float t = plane_t(s_pl[2 * j], s_pl[2 * j + 1], ro, rd, eps);
        if (t < best) best = t, winner = (base + j) << 4 | 1;
      }
  }
  for (int base = 0; base < n_cyl; base += kCylinders) {
    if (!__syncthreads_or(live)) goto done;
    const int m = min(kCylinders, n_cyl - base);
    for (int j = tid; j < m; j += kThreads) {
      const float3 b = load3(cyl_base, base + j), a = load3(cyl_axis, base + j);
      const float r = __ldg(cyl_radius + base + j), h = __ldg(cyl_height + base + j);
      s_cyl[4 * j] = make_float4(b.x, b.y, b.z, __fmul_rn(r, r));
      s_cyl[4 * j + 1] = make_float4(a.x, a.y, a.z, h);
      s_cyl[4 * j + 2] = make_float4(__fadd_rn(b.x, __fmul_rn(a.x, 0.0f)), __fadd_rn(b.y, __fmul_rn(a.y, 0.0f)),
                                     __fadd_rn(b.z, __fmul_rn(a.z, 0.0f)), 0.0f);
      s_cyl[4 * j + 3] = make_float4(__fadd_rn(b.x, __fmul_rn(a.x, h)), __fadd_rn(b.y, __fmul_rn(a.y, h)),
                                     __fadd_rn(b.z, __fmul_rn(a.z, h)), 0.0f);
    }
    __syncthreads();
    if (live)
      for (int j = 0; j < m; ++j) {
        const float4 b = s_cyl[4 * j], ax = s_cyl[4 * j + 1];
        const float d_dot_a = dot3(rd.x, rd.y, rd.z, ax.x, ax.y, ax.z);
        // candidate order body, cap A, cap B; each cap clipped at the
        // running closest t, which lies at or under the family's clip
        float t = body_t(b, ax, d_dot_a, ro, rd, eps);
        if (t < best) best = t, winner = (base + j) << 4 | 2;
        t = cap_t(s_cyl[4 * j + 2], ax, b.w, d_dot_a, ro, rd, best, eps);
        if (t < best) best = t, winner = (base + j) << 4 | 1 << 2 | 2;
        t = cap_t(s_cyl[4 * j + 3], ax, b.w, d_dot_a, ro, rd, best, eps);
        if (t < best) best = t, winner = (base + j) << 4 | 2 << 2 | 2;
      }
  }
done:
  if (i >= n) return;
  float3 nrm = make_float3(0.0f, 0.0f, 0.0f), col = nrm;
  const int row = winner >> 4, family = winner & 3;
  if (winner < 0) {
    best = INFINITY;
  } else if (family == 0) {
    // ops/sphere.py sphere_hit: normalize(point - centre), point = o + d * t
    const float3 c = load3(sph_center, row);
    nrm = normalized(__fsub_rn(__fadd_rn(ro.x, __fmul_rn(rd.x, best)), c.x),
                     __fsub_rn(__fadd_rn(ro.y, __fmul_rn(rd.y, best)), c.y),
                     __fsub_rn(__fadd_rn(ro.z, __fmul_rn(rd.z, best)), c.z));
    col = load3(sph_color, row);
  } else if (family == 1) {
    nrm = load3(pl_normal, row);  // ops/plane.py plane_hit: the stored normal, unflipped
    col = load3(pl_color, row);
  } else {
    // ops/cylinder.py cylinder_hit
    const float3 b = load3(cyl_base, row), a = load3(cyl_axis, row);
    if (((winner >> 2) & 3) == 0) {
      const float hx = __fsub_rn(__fadd_rn(ro.x, __fmul_rn(rd.x, best)), b.x);
      const float hy = __fsub_rn(__fadd_rn(ro.y, __fmul_rn(rd.y, best)), b.y);
      const float hz = __fsub_rn(__fadd_rn(ro.z, __fmul_rn(rd.z, best)), b.z);
      const float ax_fac = dot3(hx, hy, hz, a.x, a.y, a.z);
      nrm = normalized(__fsub_rn(hx, __fmul_rn(a.x, ax_fac)), __fsub_rn(hy, __fmul_rn(a.y, ax_fac)),
                       __fsub_rn(hz, __fmul_rn(a.z, ax_fac)));
    } else {
      const bool flip = dot3(rd.x, rd.y, rd.z, a.x, a.y, a.z) > 0.0f;
      nrm = flip ? make_float3(-a.x, -a.y, -a.z) : a;
    }
    if (!color_bug) col = load3(cyl_color, row);
  }
  t_out[i] = best;
  store3(normal_out, i, nrm);
  store3(color_out, i, col);
  winner_out[i] = winner;
}

}  // namespace

// o, d (n, 3) and t_max (n,) f32; the sphere table: centres (n_sph, 3),
// radii (n_sph,), colours (n_sph, 3); the plane table: points, normals,
// colours (n_pl, 3); the cylinder table: bases, axes (>= n_cyl, 3), radii,
// heights (>= n_cyl,), colours (>= n_cyl, 3), of which the first n_cyl rows
// are tested; out: t (n,), normal, colour (n, 3) f32, winner (n,) int32.
// Every table holds fewer than 2^27 rows (the winner code's row field).
extern "C" int dod_families_closest(const void* o, const void* d, const void* t_max, const void* sph_center,
                                    const void* sph_radius, const void* sph_color, const void* pl_point,
                                    const void* pl_normal, const void* pl_color, const void* cyl_base,
                                    const void* cyl_axis, const void* cyl_radius, const void* cyl_height,
                                    const void* cyl_color, void* t_out, void* normal_out, void* color_out,
                                    void* winner_out, int n, int n_sph, int n_pl, int n_cyl, float eps,
                                    int color_bug, void* stream) {
  if (n <= 0) return 0;
  if (n_sph < 0 || n_pl < 0 || n_cyl < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  families_closest_hit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t_max),
      static_cast<const float*>(sph_center), static_cast<const float*>(sph_radius),
      static_cast<const float*>(sph_color), static_cast<const float*>(pl_point),
      static_cast<const float*>(pl_normal), static_cast<const float*>(pl_color),
      static_cast<const float*>(cyl_base), static_cast<const float*>(cyl_axis),
      static_cast<const float*>(cyl_radius), static_cast<const float*>(cyl_height),
      static_cast<const float*>(cyl_color), static_cast<float*>(t_out), static_cast<float*>(normal_out),
      static_cast<float*>(color_out), static_cast<int*>(winner_out), n, n_sph, n_pl, n_cyl, eps, color_bug);
  return static_cast<int>(cudaGetLastError());
}

// Any-hit of a shadow wavefront against the sphere, plane and cylinder
// families on the H100 (sm_90a).  It replaces no TPU kernel: the JAX package
// computes these tests in XLA (dod_raytracer_tpu/intersect.py
// occluded_families).  The port's plain version is the torch composition
// ops/families.py occluded_plain (ops/sphere.py occluded_spheres |
// ops/plane.py occluded_planes | ops/cylinder.py occluded_cylinders), which
// writes and rereads (N, S, 3) float intermediates in some 180 launches; this
// kernel keeps every intermediate in registers, in one launch.
//
// One thread per lane.  Each CTA stages the family tables in shared memory,
// in chunks of at most kSpheres / kPlanes / kCylinders rows, read straight
// from the scene's tensors: any count of each family works.  The
// ray-independent terms are computed once at staging, as the torch version
// computes them (radius * radius; the cap centres base + axis * 0 and
// base + axis * height).  A lane whose t_max cannot admit a hit (t_max <= 0
// or NaN, with eps >= 0: every family needs 0 <= t < t_max) writes false
// without loading its ray; a lane stops at its first blocker (the answer is
// an OR, so the order of the tests cannot change it), and a CTA stops
// staging once none of its lanes is left to test.
//
// Same bits as the plain version on the card: each expression is the torch
// version's, in its order, one rounded operation at a time (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn; no contraction into FMAs).
// A torch.sum over a last dimension of 3 on CUDA gives (x0 + x2) + x1: the
// reduce kernel spreads a row of 3 over two threads of a warp, one summing x0
// and x2, the other holding x1, and a shuffle adds the two (sum3 below).
// The predicates are the torch version's, including its quirks: the sphere's
// origin-outside, closest-approach and both-roots-in-front tests; the
// plane's |d.n| > eps and t > eps; the cylinder body's disc >= eps, a != 0,
// minNonNegative and axis range; the caps' |d.a| >= eps, eps <= t <= t_max
// and radius test; every candidate strictly below t_max; cylinder columns
// at or past n_cyl never hit.
//
// What bounds it on this card: bytes.  A lane reads its origin, direction
// and t_max (28 B) and writes one bool (1 B); at the frame's 9,331,200
// lanes that is 270.6 MB, 0.081 ms at 3.35 TB/s.  Its fp32 operations, at
// most about 500 a lane with no early exit (16 spheres, 6 planes, one
// cylinder), take 0.070 ms at 67 TFLOP/s.
//
// C entry point: dod_families_any(...) launches on the given stream and
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

// ops/sphere.py sphere_candidate_t for one sphere (c: centre, w: r * r),
// then the any-hit test candidate < t_max.
__device__ __forceinline__ bool sphere_blocks(const float4 c, const float3& o, const float3& d, float t_max) {
  const float lx = __fsub_rn(c.x, o.x), ly = __fsub_rn(c.y, o.y), lz = __fsub_rn(c.z, o.z);
  const float dist_sq = dot3(lx, ly, lz, lx, ly, lz);
  const float tca = dot3(lx, ly, lz, d.x, d.y, d.z);
  const float d2 = __fsub_rn(dist_sq, __fmul_rn(tca, tca));
  if (!(dist_sq > c.w) || !(d2 < c.w)) return false;
  const float x = __fsub_rn(c.w, d2);
  const float thc = x > 0.0f ? __fsqrt_rn(x) : 0.0f;  // utils/math.py safe_sqrt
  const float t0 = __fsub_rn(tca, thc), t1 = __fadd_rn(tca, thc);
  return t0 >= 0.0f && t1 >= 0.0f && fminf(t0, t1) < t_max;
}

// ops/plane.py plane_candidate_t for one plane (p: point, n: normal).
__device__ __forceinline__ bool plane_blocks(const float4 p, const float4 n, const float3& o, const float3& d,
                                             float t_max, float eps) {
  const float denom = dot3(d.x, d.y, d.z, n.x, n.y, n.z);
  if (!(fabsf(denom) > eps)) return false;
  const float num = dot3(__fsub_rn(p.x, o.x), __fsub_rn(p.y, o.y), __fsub_rn(p.z, o.z), n.x, n.y, n.z);
  const float t = __fdiv_rn(num, denom);
  return t > eps && t < t_max;
}

// One cap of ops/cylinder.py cylinder_candidate_t (disc_t), centre c.
__device__ __forceinline__ bool cap_blocks(const float4 c, const float4 ax, const float r_sq, const float d_dot_a,
                                           const float3& o, const float3& d, float t_max, float eps) {
  if (!(fabsf(d_dot_a) >= eps)) return false;
  const float num = dot3(__fsub_rn(c.x, o.x), __fsub_rn(c.y, o.y), __fsub_rn(c.z, o.z), ax.x, ax.y, ax.z);
  const float t = __fdiv_rn(num, d_dot_a);
  if (!(t >= eps) || !(t < t_max)) return false;  // disc_t's t <= t_max, then the any-hit's t < t_max
  const float qx = __fsub_rn(__fadd_rn(o.x, __fmul_rn(d.x, t)), c.x);
  const float qy = __fsub_rn(__fadd_rn(o.y, __fmul_rn(d.y, t)), c.y);
  const float qz = __fsub_rn(__fadd_rn(o.z, __fmul_rn(d.z, t)), c.z);
  return dot3(qx, qy, qz, qx, qy, qz) <= r_sq;
}

// ops/cylinder.py cylinder_candidate_t for one cylinder: the body, then the
// caps at offsets 0 and height.  b: base and r * r; ax: axis and height;
// ca, cb: the cap centres.
__device__ __forceinline__ bool cylinder_blocks(const float4 b, const float4 ax, const float4 ca, const float4 cb,
                                                const float3& o, const float3& d, float t_max, float eps) {
  const float r_sq = b.w, height = ax.w;
  const float d_dot_a = dot3(d.x, d.y, d.z, ax.x, ax.y, ax.z);
  // body (cylinder.cpp:76-118)
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
  const float c = __fsub_rn(dot3(qx, qy, qz, qx, qy, qz), r_sq);
  const float disc = __fsub_rn(__fmul_rn(bb, bb), __fmul_rn(__fmul_rn(4.0f, a), c));
  if (disc >= eps && a != 0.0f) {
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
    if (isfinite(t)) {
      const float hx = __fsub_rn(__fadd_rn(o.x, __fmul_rn(d.x, t)), b.x);
      const float hy = __fsub_rn(__fadd_rn(o.y, __fmul_rn(d.y, t)), b.y);
      const float hz = __fsub_rn(__fadd_rn(o.z, __fmul_rn(d.z, t)), b.z);
      const float axis_factor = dot3(hx, hy, hz, ax.x, ax.y, ax.z);
      if (axis_factor >= 0.0f && axis_factor <= height && t < t_max) return true;
    }
  }
  // caps (cylinder.cpp:120-152)
  return cap_blocks(ca, ax, r_sq, d_dot_a, o, d, t_max, eps) || cap_blocks(cb, ax, r_sq, d_dot_a, o, d, t_max, eps);
}

__global__ void __launch_bounds__(kThreads) families_any_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_max,
    const float* __restrict__ sph_center, const float* __restrict__ sph_radius,
    const float* __restrict__ pl_point, const float* __restrict__ pl_normal,
    const float* __restrict__ cyl_base, const float* __restrict__ cyl_axis,
    const float* __restrict__ cyl_radius, const float* __restrict__ cyl_height,
    unsigned char* __restrict__ out, int n, int n_sph, int n_pl, int n_cyl, float eps) {
  __shared__ float4 s_sph[kSpheres];         // centre, r * r
  __shared__ float4 s_pl[2 * kPlanes];       // point, normal
  __shared__ float4 s_cyl[4 * kCylinders];   // base and r * r, axis and height, cap centres

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int tid = threadIdx.x;
  float tm = 0.0f;
  float3 ro = make_float3(0.0f, 0.0f, 0.0f), rd = ro;
  bool pending = false;  // live and not yet blocked
  if (i < n) {
    tm = __ldg(t_max + i);
    pending = !(eps >= 0.0f) || tm > 0.0f;
    if (pending) {
      ro = make_float3(__ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2));
      rd = make_float3(__ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2));
    }
  }
  bool blocked = false;

  // each chunk begins with a barrier that also tells whether any lane of
  // the CTA is still pending: if none is, the CTA is done
  for (int base = 0; base < n_sph; base += kSpheres) {
    if (!__syncthreads_or(pending)) goto done;
    const int m = min(kSpheres, n_sph - base);
    for (int j = tid; j < m; j += kThreads) {
      const float r = __ldg(sph_radius + base + j);
      const float* c = sph_center + 3 * (base + j);
      s_sph[j] = make_float4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __fmul_rn(r, r));
    }
    __syncthreads();
    for (int j = 0; pending && j < m; ++j)
      if (sphere_blocks(s_sph[j], ro, rd, tm)) blocked = true, pending = false;
  }
  for (int base = 0; base < n_pl; base += kPlanes) {
    if (!__syncthreads_or(pending)) goto done;
    const int m = min(kPlanes, n_pl - base);
    for (int j = tid; j < m; j += kThreads) {
      const float* p = pl_point + 3 * (base + j);
      const float* q = pl_normal + 3 * (base + j);
      s_pl[2 * j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.0f);
      s_pl[2 * j + 1] = make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), 0.0f);
    }
    __syncthreads();
    for (int j = 0; pending && j < m; ++j)
      if (plane_blocks(s_pl[2 * j], s_pl[2 * j + 1], ro, rd, tm, eps)) blocked = true, pending = false;
  }
  for (int base = 0; base < n_cyl; base += kCylinders) {
    if (!__syncthreads_or(pending)) goto done;
    const int m = min(kCylinders, n_cyl - base);
    for (int j = tid; j < m; j += kThreads) {
      const float* b = cyl_base + 3 * (base + j);
      const float* a = cyl_axis + 3 * (base + j);
      const float r = __ldg(cyl_radius + base + j), h = __ldg(cyl_height + base + j);
      const float bx = __ldg(b), by = __ldg(b + 1), bz = __ldg(b + 2);
      const float ax = __ldg(a), ay = __ldg(a + 1), az = __ldg(a + 2);
      s_cyl[4 * j] = make_float4(bx, by, bz, __fmul_rn(r, r));
      s_cyl[4 * j + 1] = make_float4(ax, ay, az, h);
      s_cyl[4 * j + 2] = make_float4(__fadd_rn(bx, __fmul_rn(ax, 0.0f)), __fadd_rn(by, __fmul_rn(ay, 0.0f)),
                                     __fadd_rn(bz, __fmul_rn(az, 0.0f)), 0.0f);
      s_cyl[4 * j + 3] = make_float4(__fadd_rn(bx, __fmul_rn(ax, h)), __fadd_rn(by, __fmul_rn(ay, h)),
                                     __fadd_rn(bz, __fmul_rn(az, h)), 0.0f);
    }
    __syncthreads();
    for (int j = 0; pending && j < m; ++j)
      if (cylinder_blocks(s_cyl[4 * j], s_cyl[4 * j + 1], s_cyl[4 * j + 2], s_cyl[4 * j + 3], ro, rd, tm, eps))
        blocked = true, pending = false;
  }
done:
  if (i < n) out[i] = blocked ? 1 : 0;
}

}  // namespace

// o, d (n, 3) and t_max (n,) f32; the sphere table: centres (n_sph, 3),
// radii (n_sph,); the plane table: points, normals (n_pl, 3); the cylinder
// table: bases, axes (>= n_cyl, 3), radii, heights (>= n_cyl,), of which
// the first n_cyl rows are tested; out (n,) bool (one byte, 0 or 1).
extern "C" int dod_families_any(const void* o, const void* d, const void* t_max, const void* sph_center,
                                const void* sph_radius, const void* pl_point, const void* pl_normal,
                                const void* cyl_base, const void* cyl_axis, const void* cyl_radius,
                                const void* cyl_height, void* out, int n, int n_sph, int n_pl, int n_cyl,
                                float eps, void* stream) {
  if (n <= 0) return 0;
  if (n_sph < 0 || n_pl < 0 || n_cyl < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  families_any_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t_max),
      static_cast<const float*>(sph_center), static_cast<const float*>(sph_radius),
      static_cast<const float*>(pl_point), static_cast<const float*>(pl_normal),
      static_cast<const float*>(cyl_base), static_cast<const float*>(cyl_axis),
      static_cast<const float*>(cyl_radius), static_cast<const float*>(cyl_height),
      static_cast<unsigned char*>(out), n, n_sph, n_pl, n_cyl, eps);
  return static_cast<int>(cudaGetLastError());
}

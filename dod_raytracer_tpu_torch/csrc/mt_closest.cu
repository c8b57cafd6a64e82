// Brute-force Möller–Trumbore closest hit for the H100 (sm_90a): every ray
// against every triangle.
//
// Replaces: dod_raytracer_tpu/ops/pallas/mt_kernel.py, mt_closest_pallas /
// _mt_kernel.  Same inputs but for the ray layout: the (9, T') SoA rows
// [A | B-A | C-A] of swizzle_tris, T' a multiple of 512, and the rays as
// (N, 3) o and d (the TPU kernel reads swizzle_rays' (N', 8) rows).  Same
// outputs (t, idx): the closest hit over all triangles, the lowest index
// winning a tie, (inf, 0) for a miss.
//
// Each pair is the JAX kernel's expressions, every product and sum rounded
// on its own (__fmul_rn / __fadd_rn / __fsub_rn, no FMA contraction) and
// 1/det correctly rounded (__frcp_rn).  That is the port's ops/triangle.py
// mt_t_edges without `inside`, so the kernel gives brute_force_closest's
// bits (its plain version, ops/mt.py).  No tensor cores, no TF32.
//
// What bounds it on this card: issue slots.  A full pair test is 46 fp32
// operations (27 multiplies, 18 adds, one reciprocal), none of which may
// fuse into an FMA, plus the compares; the 1080p teapot frame's primary
// rays against its 6,320 triangles are 13.1G pairs, 9 ms at 67 TFLOP/s
// (an FMA counted as two flops) but 18 ms at the card's rate of one
// instruction per lane and cycle.  The triangles are 240 KB, the rays 50 MB.
// The kernel it replaced (mt_closest_per_ray_kernel below, one thread per
// ray, every CTA over all triangles) paid all 46 operations and the
// multi-instruction reciprocal on every pair, and left half the card idle
// at the 480x270 frame's 16,384-ray launches (64 CTAs on 132 SMs).
//
// Design (brute.cuh): the triangle axis is split over CTAs when the rays
// alone would not fill the card, and the splits merge by an exact 64-bit
// (t, index) atomicMin; a thread holds two rays, so one read of a staged
// triangle (three 16-byte broadcast loads, [A, 0] [e1, 0] [e2, 0]) serves
// two pairs; the next tile arrives by cp.async during the scan; the scan
// stops at the last non-zero triangle.  Exact early exits: u, v and t are
// each a numerator times inv_det = __frcp_rn(det), and the reciprocal keeps
// det's sign (or is NaN, or a zero or infinity of det's sign).  A product
// with a zero or NaN factor, or of factors of opposite signs, is <= 0 or
// NaN, so u > 0, v > 0 and t > 0 each need their numerator to share det's
// strict sign.  The test computes p, det and the u numerator t.p first and
// stops a pair whose signs differ (or are zero or NaN); then the v
// numerator d.q, the same way; then the t numerator e2.q.  Only a pair
// that passes all three pays for the reciprocal and the three products,
// with every operation it does compute in the same rounding as before.
// The saving counts where a whole warp (32 consecutive rays) stops; the
// stats build counts the warp-steps by the stage they reached.
//
// C entry points launch on the given stream and return cudaGetLastError();
// they allocate nothing and do not synchronize.  dod_mt_closest is the
// render path's (brute.cuh launch); dod_mt_closest_per_ray is the kernel it
// replaced, kept for measurement only.

#include "brute.cuh"

namespace {

using brute::kRays;

struct MtTest {
  static constexpr int kRows = 9;   // [A | B - A | C - A]
  static constexpr int kQuads = 3;  // staged as [A, 0] [e1, 0] [e2, 0]
  __host__ __device__ static constexpr int source_row(int row) { return row; }
  __host__ __device__ static constexpr int slot(int row) { return row + row / 3; }

  struct Ray {
    float ox, oy, oz, dx, dy, dz;
  };

  __device__ static Ray load(const float* o, const float* d, int i) {
    if (i < 0) return Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const size_t k = 3 * static_cast<size_t>(i);
    return Ray{o[k], o[k + 1], o[k + 2], d[k], d[k + 1], d[k + 2]};
  }

  // The pair test of one staged triangle against the thread's rays;
  // reached[r]: 0 stopped at the sign of u, 1 of v, 2 of t, 3 whole test.
  template <bool kStats>
  __device__ __forceinline__ static void pairs(const float4* tri, const Ray (&ray)[kRays],
                                               float (&best)[kRays], int (&best_idx)[kRays], int index,
                                               int (&reached)[kRays]) {
    const float4 a = tri[0], e1 = tri[1], e2 = tri[2];
    float px[kRays], py[kRays], pz[kRays], det[kRays], tx[kRays], ty[kRays], tz[kRays], un[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const Ray& q = ray[r];
      // pvec = d x e2; det = pvec . e1
      px[r] = __fsub_rn(__fmul_rn(q.dy, e2.z), __fmul_rn(q.dz, e2.y));
      py[r] = __fsub_rn(__fmul_rn(q.dz, e2.x), __fmul_rn(q.dx, e2.z));
      pz[r] = __fsub_rn(__fmul_rn(q.dx, e2.y), __fmul_rn(q.dy, e2.x));
      det[r] = __fadd_rn(__fadd_rn(__fmul_rn(px[r], e1.x), __fmul_rn(py[r], e1.y)), __fmul_rn(pz[r], e1.z));
      // tvec = o - A; the u numerator tvec . pvec
      tx[r] = __fsub_rn(q.ox, a.x);
      ty[r] = __fsub_rn(q.oy, a.y);
      tz[r] = __fsub_rn(q.oz, a.z);
      un[r] = __fadd_rn(__fadd_rn(__fmul_rn(tx[r], px[r]), __fmul_rn(ty[r], py[r])), __fmul_rn(tz[r], pz[r]));
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      if (kStats) reached[r] = 0;
      if (!brute::same_sign(det[r], un[r])) continue;  // u > 0 cannot hold
      const Ray& q = ray[r];
      // qvec = tvec x e1; the v numerator d . qvec
      const float qx = __fsub_rn(__fmul_rn(ty[r], e1.z), __fmul_rn(tz[r], e1.y));
      const float qy = __fsub_rn(__fmul_rn(tz[r], e1.x), __fmul_rn(tx[r], e1.z));
      const float qz = __fsub_rn(__fmul_rn(tx[r], e1.y), __fmul_rn(ty[r], e1.x));
      const float vn = __fadd_rn(__fadd_rn(__fmul_rn(q.dx, qx), __fmul_rn(q.dy, qy)), __fmul_rn(q.dz, qz));
      if (kStats) reached[r] = 1;
      if (!brute::same_sign(det[r], vn)) continue;  // v > 0 cannot hold
      // the t numerator e2 . qvec
      const float tn = __fadd_rn(__fadd_rn(__fmul_rn(e2.x, qx), __fmul_rn(e2.y, qy)), __fmul_rn(e2.z, qz));
      if (kStats) reached[r] = 2;
      if (!brute::same_sign(det[r], tn)) continue;  // t > 0 cannot hold
      if (kStats) reached[r] = 3;
      const float inv_det = __frcp_rn(det[r]);
      const float u = __fmul_rn(un[r], inv_det);
      const float v = __fmul_rn(vn, inv_det);
      const float t = __fmul_rn(tn, inv_det);
      const bool valid = fabsf(det[r]) > 0.0f && u > 0.0f && u < 1.0f && v > 0.0f &&
                         __fadd_rn(u, v) < 1.0f && t > 0.0f;
      if (valid && t < best[r]) {
        best[r] = t;
        best_idx[r] = index;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The per-ray kernel the split kernel replaced, for measurement only: a CTA
// of 256 rays, one thread per ray, stages 512-triangle tiles of the SoA (18
// KB) and scans all T' triangles with the whole test on every pair.

constexpr int kRayThreads = 256;  // rays per CTA
constexpr int kRayTile = 512;     // triangles per shared-memory tile (ops/mt.py TILE_T)
constexpr int kRows = 9;

__global__ void __launch_bounds__(kRayThreads)
mt_closest_per_ray_kernel(const float* __restrict__ tris, const float* __restrict__ o,
                          const float* __restrict__ d, float* __restrict__ t_out, int* __restrict__ idx_out,
                          int n, int t_total) {
  __shared__ float tile[kRows][kRayTile];
  const int i = blockIdx.x * kRayThreads + threadIdx.x;
  const bool live = i < n;  // dead threads still stage tiles
  const size_t ray = 3 * static_cast<size_t>(live ? i : 0);
  const float ox = o[ray], oy = o[ray + 1], oz = o[ray + 2];
  const float dx = d[ray], dy = d[ray + 1], dz = d[ray + 2];
  float best = INFINITY;
  int best_idx = 0;
  for (int base = 0; base < t_total; base += kRayTile) {
    __syncthreads();
    for (int k = threadIdx.x; k < kRows * kRayTile; k += kRayThreads) {
      const int row = k / kRayTile, col = k - row * kRayTile;
      tile[row][col] = __ldg(tris + static_cast<size_t>(row) * t_total + base + col);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kRayTile; ++j) {
      const float ax = tile[0][j], ay = tile[1][j], az = tile[2][j];
      const float e1x = tile[3][j], e1y = tile[4][j], e1z = tile[5][j];
      const float e2x = tile[6][j], e2y = tile[7][j], e2z = tile[8][j];
      // pvec = d x e2; det = pvec . e1
      const float px = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
      const float py = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
      const float pz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
      const float det = __fadd_rn(__fadd_rn(__fmul_rn(px, e1x), __fmul_rn(py, e1y)), __fmul_rn(pz, e1z));
      const float inv_det = __frcp_rn(det);
      // tvec = o - A; u = (tvec . pvec) / det
      const float tx = __fsub_rn(ox, ax), ty = __fsub_rn(oy, ay), tz = __fsub_rn(oz, az);
      const float u = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)), __fmul_rn(tz, pz)), inv_det);
      // qvec = tvec x e1; v = (d . qvec) / det; t = (e2 . qvec) / det
      const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
      const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
      const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
      const float v = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, qx), __fmul_rn(dy, qy)), __fmul_rn(dz, qz)), inv_det);
      const float t = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)), __fmul_rn(e2z, qz)), inv_det);
      const bool valid = fabsf(det) > 0.0f && u > 0.0f && u < 1.0f && v > 0.0f &&
                         __fadd_rn(u, v) < 1.0f && t > 0.0f;
      if (valid && t < best) {
        best = t;
        best_idx = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = best_idx;
  }
}

}  // namespace

// The render path's kernel: `keys` (n uint64, filled with (bits(+inf) <<
// 32) | 0) is needed for splits > 1; `stats` ((2, 4) uint64, zeroed) only
// for measurement.
extern "C" int dod_mt_closest(const void* tris, const void* o, const void* d, void* t_out, void* idx_out,
                              void* keys, void* stats, int n, int t_total, int splits, void* stream) {
  return brute::launch<MtTest>(tris, o, d, t_out, idx_out, keys, stats, n, t_total, splits, stream);
}

// The per-ray kernel it replaced (measurement only).
extern "C" int dod_mt_closest_per_ray(const void* tris, const void* o, const void* d, void* t_out,
                                      void* idx_out, int n, int t_total, void* stream) {
  if (n <= 0) return 0;
  if (t_total < kRayTile || t_total % kRayTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRayThreads - 1) / kRayThreads);
  mt_closest_per_ray_kernel<<<grid, kRayThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tris), static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<float*>(t_out), static_cast<int*>(idx_out), n, t_total);
  return static_cast<int>(cudaGetLastError());
}

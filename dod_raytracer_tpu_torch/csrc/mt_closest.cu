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
// Each pair is the JAX kernel's expressions in its order, every product and
// sum rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, no FMA
// contraction) and 1/det correctly rounded (__frcp_rn).  That is the
// port's ops/triangle.py mt_t_edges without `inside`, so the kernel gives
// brute_force_closest's bits (its plain version, ops/mt.py).
//
// What bounds it on this card: fp32 throughput.  A pair costs 46 fp32
// operations (27 multiplies, 18 adds, one reciprocal) and a few compares;
// the 1080p teapot frame's primary rays against its 6,320 triangles are
// 13.1G pairs, about 9 ms at 67 TFLOP/s, while the triangles are 240 KB
// and the rays 50 MB.
//
// Design (simple first): a CTA of 256 rays, one thread per ray.  The CTA
// stages one 512-triangle tile of the SoA (18 KB) in shared memory at a
// time; every thread reads each triangle as a broadcast and scans the tile
// in index order with a strict <, so the running minimum keeps the lowest
// index.  The TPU kernel's (ray tile, triangle tile) grid with its output
// block carried across triangle tiles becomes this loop inside the CTA.
//
// C entry point: dod_mt_closest(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronize.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // rays per CTA
constexpr int kTile = 512;     // triangles per shared-memory tile (ops/mt.py TILE_T)
constexpr int kRows = 9;

__global__ void __launch_bounds__(kThreads)
mt_closest_kernel(const float* __restrict__ tris, const float* __restrict__ o,
                  const float* __restrict__ d, float* __restrict__ t_out, int* __restrict__ idx_out, int n,
                  int t_total) {
  __shared__ float tile[kRows][kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;  // dead threads still stage tiles
  const size_t ray = 3 * static_cast<size_t>(live ? i : 0);
  const float ox = o[ray], oy = o[ray + 1], oz = o[ray + 2];
  const float dx = d[ray], dy = d[ray + 1], dz = d[ray + 2];
  float best = INFINITY;
  int best_idx = 0;
  for (int base = 0; base < t_total; base += kTile) {
    __syncthreads();
    for (int k = threadIdx.x; k < kRows * kTile; k += kThreads) {
      const int row = k / kTile, col = k - row * kTile;
      tile[row][col] = __ldg(tris + static_cast<size_t>(row) * t_total + base + col);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
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

extern "C" int dod_mt_closest(const void* tris, const void* o, const void* d, void* t_out,
                              void* idx_out, int n, int t_total, void* stream) {
  if (n <= 0) return 0;
  if (t_total < kTile || t_total % kTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  mt_closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tris), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<float*>(t_out), static_cast<int*>(idx_out), n, t_total);
  return static_cast<int>(cudaGetLastError());
}

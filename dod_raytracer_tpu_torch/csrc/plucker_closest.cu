// Brute-force closest hit in Plücker form for the H100 (sm_90a): every ray
// against every triangle.
//
// Replaces: dod_raytracer_tpu/ops/pallas/plucker_kernel.py, plucker_closest /
// _plucker_kernel.  Same inputs but for the ray layout: the (5, 10, T')
// packed columns of plucker_pack, T' a multiple of 512, and the rays as
// (N, 3) o and d, from which each thread builds in registers the row
// [d, o x d, o, 1] that the TPU kernel reads from swizzle_rays_plucker.
// Same outputs (t, idx): the closest hit over all triangles, the lowest
// index winning a tie, (inf, 0) for a miss.  A pair
// hits when its three edge sides s0, s1, s2 share a strict sign and den != 0;
// t = num / den > 0 with the packed n.A, the TPU kernel's distance (not
// Möller–Trumbore's).
//
// The TPU kernel takes the five sums r . column as HIGHEST-precision MXU
// matmuls.  Here each is summed in row order, every product and sum rounded
// on its own (__fmul_rn / __fadd_rn: no FMA contraction, no TF32, no tensor
// cores), over the rows that are not zero by construction: 6 for each side,
// 3 for den, 4 for num.  ops/plucker.py plucker_closest_plain repeats those
// operations in torch, so the kernel gives its bits.
//
// What bounds it on this card: fp32 throughput.  A pair costs 46 fp32
// operations (25 multiplies, 20 adds, one division) and a few compares; the
// 1080p teapot frame's primary rays against its 6,320 triangles are 13.1G
// pairs, about 9 ms at 67 TFLOP/s, while the packed columns are 1.3 MB and
// the rays 50 MB.
//
// Design (simple first, as mt_closest.cu): a CTA of 256 rays, one thread per
// ray.  The CTA stages the 25 non-zero rows of one 256-triangle tile (25.6
// KB) in shared memory at a time; every thread reads each column as a
// broadcast and scans the tile in index order with a strict <, so the
// running minimum keeps the lowest index.
//
// C entry point: dod_plucker_closest(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronize.

#include "kd_leaf.cuh"

namespace {

constexpr int kThreads = 256;  // rays per CTA
constexpr int kTile = 256;     // triangles per shared-memory tile
constexpr int kPad = 512;      // ops/plucker.py TILE_T: T' is a multiple of it
// staged rows: s0, s1, s2 rows 0-5 (0-17), den rows 0-2 (18-20), num rows 6-9 (21-24)
constexpr int kRows = 25;

__device__ __forceinline__ int source_row(int row) {  // -> section * 10 + feature row
  if (row < 18) return (row / 6) * 10 + row % 6;
  if (row < 21) return 30 + row - 18;
  return 40 + 6 + row - 21;
}

__global__ void __launch_bounds__(kThreads)
plucker_closest_kernel(const float* __restrict__ g, const float* __restrict__ o_in,
                       const float* __restrict__ d_in, float* __restrict__ t_out, int* __restrict__ idx_out, int n,
                       int t_total) {
  __shared__ float tile[kRows][kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;  // dead threads still stage tiles
  const size_t ray = 3 * static_cast<size_t>(live ? i : 0);
  const float3 o = make_float3(o_in[ray], o_in[ray + 1], o_in[ray + 2]);
  const float3 d = make_float3(d_in[ray], d_in[ray + 1], d_in[ray + 2]);
  // the ray row [d, o x d, o, 1]: kd_leaf.cuh plucker_row gives the torch
  // plucker_row's bits for the first six
  float r[10];
  kdleaf::plucker_row(o, d, r);
  r[6] = o.x;
  r[7] = o.y;
  r[8] = o.z;
  r[9] = 1.0f;
  float best = INFINITY;
  int best_idx = 0;
  for (int base = 0; base < t_total; base += kTile) {
    __syncthreads();
    for (int k = threadIdx.x; k < kRows * kTile; k += kThreads) {
      const int row = k / kTile, col = k - row * kTile;
      tile[row][col] = __ldg(g + static_cast<size_t>(source_row(row)) * t_total + base + col);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float s[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        s[e] = __fmul_rn(r[0], tile[6 * e][j]);
#pragma unroll
        for (int k = 1; k < 6; ++k) s[e] = __fadd_rn(s[e], __fmul_rn(r[k], tile[6 * e + k][j]));
      }
      float den = __fmul_rn(r[0], tile[18][j]);
      den = __fadd_rn(den, __fmul_rn(r[1], tile[19][j]));
      den = __fadd_rn(den, __fmul_rn(r[2], tile[20][j]));
      float num = __fmul_rn(r[6], tile[21][j]);
#pragma unroll
      for (int k = 7; k < 10; ++k) num = __fadd_rn(num, __fmul_rn(r[k], tile[15 + k][j]));
      const bool inside = (s[0] > 0.0f && s[1] > 0.0f && s[2] > 0.0f) ||
                          (s[0] < 0.0f && s[1] < 0.0f && s[2] < 0.0f);
      const float t = __fdiv_rn(num, den);
      if (inside && den != 0.0f && t > 0.0f && t < best) {
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

extern "C" int dod_plucker_closest(const void* g, const void* o, const void* d, void* t_out,
                                   void* idx_out, int n, int t_total, void* stream) {
  if (n <= 0) return 0;
  if (t_total < kPad || t_total % kPad) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  plucker_closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<float*>(t_out), static_cast<int*>(idx_out), n, t_total);
  return static_cast<int>(cudaGetLastError());
}

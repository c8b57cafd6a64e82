// Brute-force closest hit in Plücker form for the H100 (sm_90a): every ray
// against every triangle.
//
// Replaces: dod_raytracer_tpu/ops/pallas/plucker_kernel.py, plucker_closest /
// _plucker_kernel.  Same inputs but for the ray layout: the (5, 10, T')
// packed columns of plucker_pack, T' a multiple of 512, and the rays as
// (N, 3) o and d, from which each thread builds in registers the row
// [d, o x d, o, 1] that the TPU kernel reads from swizzle_rays_plucker.
// Same outputs (t, idx): the closest hit over all triangles, the lowest
// index winning a tie, (inf, 0) for a miss.  A pair hits when its three
// edge sides s0, s1, s2 share a strict sign and den != 0; t = num / den > 0
// with the packed n.A, the TPU kernel's distance (not Möller–Trumbore's).
//
// The TPU kernel takes the five sums r . column as HIGHEST-precision MXU
// matmuls.  Here each is summed in row order, every product and sum rounded
// on its own (__fmul_rn / __fadd_rn: no FMA contraction, no TF32, no tensor
// cores), over the rows that are not zero by construction: 6 for each side,
// 3 for den, 4 for num.  ops/plucker.py plucker_closest_plain repeats those
// operations in torch, so the kernel gives its bits.
//
// What bounds it on this card: issue slots.  A full pair test is 46 fp32
// operations (25 multiplies, 20 adds, one division), none of which may fuse
// into an FMA, plus the compares and the multi-instruction IEEE division;
// the 1080p teapot frame's primary rays against its 6,320 triangles are
// 13.1G pairs, 9 ms at 67 TFLOP/s (an FMA counted as two flops), 18 ms at
// one instruction per lane and cycle.  The packed columns are 1.3 MB, the
// rays 50 MB.  The kernel it replaced (plucker_closest_per_ray_kernel
// below, one thread per ray over all triangles) paid all five sums and
// __fdiv_rn on every pair and left half the card idle at the 480x270
// frame's 16,384-ray launches.
//
// Design (brute.cuh, as mt_closest.cu): the triangle axis split over CTAs
// with the exact 64-bit (t, index) merge; two rays a thread; the 25 rows of
// a triangle staged as seven 16-byte groups ([s0 0-3] [s0 4-5, s1 0-1]
// [s1 2-5] [s2 0-3] [s2 4-5, den 0-1] [den 2, num 6-8] [num 9]) by a
// cp.async ring; the scan stops at the last non-zero column.  Exact early
// exits: a hit needs s0, s1 and s2 all > 0 or all < 0, so the test sums s0
// and s1 first (three 16-byte loads) and stops a pair unless both share a
// strict sign; then s2, the same way.  Then den and num: t = num / den > 0
// needs num and den of one strict sign (a quotient with a zero or NaN
// operand, or of operands of opposite signs, is <= 0 or NaN; den != 0
// follows), so only those pairs, about the hits, pay for __fdiv_rn.  Every
// sum a pair does compute keeps its rounding and row order.
//
// C entry points launch on the given stream and return cudaGetLastError();
// they allocate nothing and do not synchronize.  dod_plucker_closest is the
// render path's (brute.cuh launch); dod_plucker_closest_per_ray is the
// kernel it replaced, kept for measurement only.

#include "brute.cuh"
#include "kd_leaf.cuh"

namespace {

using brute::kRays;

// staged rows: s0, s1, s2 rows 0-5 (0-17), den rows 0-2 (18-20), num rows 6-9 (21-24)
constexpr int kRows = 25;

__host__ __device__ constexpr int source_row(int row) {  // -> section * 10 + feature row
  return row < 18 ? (row / 6) * 10 + row % 6 : row < 21 ? 30 + row - 18 : 40 + 6 + row - 21;
}

struct PluckerTest {
  static constexpr int kRows = ::kRows;
  static constexpr int kQuads = 7;  // the 25 rows in order, 16 bytes at a time
  __host__ __device__ static constexpr int source_row(int row) { return ::source_row(row); }
  __host__ __device__ static constexpr int slot(int row) { return row; }

  struct Ray {
    float r[6];  // [d, o x d]
    float ox, oy, oz;
  };

  __device__ static Ray load(const float* o, const float* d, int i) {
    Ray q{};
    if (i < 0) return q;
    const size_t k = 3 * static_cast<size_t>(i);
    const float3 oo = make_float3(o[k], o[k + 1], o[k + 2]);
    kdleaf::plucker_row(oo, make_float3(d[k], d[k + 1], d[k + 2]), q.r);
    q.ox = oo.x;
    q.oy = oo.y;
    q.oz = oo.z;
    return q;
  }

  // The pair test of one staged column against the thread's rays;
  // reached[r]: 0 stopped at the signs of s0 and s1, 1 of s2, 2 of num and
  // den, 3 whole test.
  template <bool kStats>
  __device__ __forceinline__ static void pairs(const float4* col, const Ray (&ray)[kRays],
                                               float (&best)[kRays], int (&best_idx)[kRays], int index,
                                               int (&reached)[kRays]) {
    const float4 c0 = col[0], c1 = col[1], c2 = col[2];
    float s0[kRays], s1[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const float* x = ray[r].r;
      float a = __fmul_rn(x[0], c0.x);
      a = __fadd_rn(a, __fmul_rn(x[1], c0.y));
      a = __fadd_rn(a, __fmul_rn(x[2], c0.z));
      a = __fadd_rn(a, __fmul_rn(x[3], c0.w));
      a = __fadd_rn(a, __fmul_rn(x[4], c1.x));
      s0[r] = __fadd_rn(a, __fmul_rn(x[5], c1.y));
      float b = __fmul_rn(x[0], c1.z);
      b = __fadd_rn(b, __fmul_rn(x[1], c1.w));
      b = __fadd_rn(b, __fmul_rn(x[2], c2.x));
      b = __fadd_rn(b, __fmul_rn(x[3], c2.y));
      b = __fadd_rn(b, __fmul_rn(x[4], c2.z));
      s1[r] = __fadd_rn(b, __fmul_rn(x[5], c2.w));
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      if (kStats) reached[r] = 0;
      if (!brute::same_sign(s0[r], s1[r])) continue;  // not inside edges 0 and 1
      const float* x = ray[r].r;
      const float4 c3 = col[3], c4 = col[4];
      float s2 = __fmul_rn(x[0], c3.x);
      s2 = __fadd_rn(s2, __fmul_rn(x[1], c3.y));
      s2 = __fadd_rn(s2, __fmul_rn(x[2], c3.z));
      s2 = __fadd_rn(s2, __fmul_rn(x[3], c3.w));
      s2 = __fadd_rn(s2, __fmul_rn(x[4], c4.x));
      s2 = __fadd_rn(s2, __fmul_rn(x[5], c4.y));
      if (kStats) reached[r] = 1;
      if (!brute::same_sign(s0[r], s2)) continue;  // not inside edge 2
      const float4 c5 = col[5], c6 = col[6];
      float den = __fmul_rn(x[0], c4.z);
      den = __fadd_rn(den, __fmul_rn(x[1], c4.w));
      den = __fadd_rn(den, __fmul_rn(x[2], c5.x));
      float num = __fmul_rn(ray[r].ox, c5.y);
      num = __fadd_rn(num, __fmul_rn(ray[r].oy, c5.z));
      num = __fadd_rn(num, __fmul_rn(ray[r].oz, c5.w));
      num = __fadd_rn(num, __fmul_rn(1.0f, c6.x));
      if (kStats) reached[r] = 2;
      if (!brute::same_sign(num, den)) continue;  // t > 0 cannot hold
      if (kStats) reached[r] = 3;
      const float t = __fdiv_rn(num, den);
      if (t > 0.0f && t < best[r]) {
        best[r] = t;
        best_idx[r] = index;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The per-ray kernel the split kernel replaced, for measurement only: a CTA
// of 256 rays, one thread per ray, stages the 25 rows of 256-triangle tiles
// (25.6 KB) and scans all T' columns with the whole test on every pair.

constexpr int kRayThreads = 256;  // rays per CTA
constexpr int kRayTile = 256;     // triangles per shared-memory tile
constexpr int kPad = 512;         // ops/plucker.py TILE_T: T' is a multiple of it

__global__ void __launch_bounds__(kRayThreads)
plucker_closest_per_ray_kernel(const float* __restrict__ g, const float* __restrict__ o_in,
                               const float* __restrict__ d_in, float* __restrict__ t_out,
                               int* __restrict__ idx_out, int n, int t_total) {
  __shared__ float tile[kRows][kRayTile];
  const int i = blockIdx.x * kRayThreads + threadIdx.x;
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
  for (int base = 0; base < t_total; base += kRayTile) {
    __syncthreads();
    for (int k = threadIdx.x; k < kRows * kRayTile; k += kRayThreads) {
      const int row = k / kRayTile, col = k - row * kRayTile;
      tile[row][col] = __ldg(g + static_cast<size_t>(source_row(row)) * t_total + base + col);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kRayTile; ++j) {
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

// The render path's kernel: `keys` (n uint64, filled with (bits(+inf) <<
// 32) | 0) is needed for splits > 1; `stats` ((2, 4) uint64, zeroed) only
// for measurement.
extern "C" int dod_plucker_closest(const void* g, const void* o, const void* d, void* t_out, void* idx_out,
                                   void* keys, void* stats, int n, int t_total, int splits, void* stream) {
  return brute::launch<PluckerTest>(g, o, d, t_out, idx_out, keys, stats, n, t_total, splits, stream);
}

// The per-ray kernel it replaced (measurement only).
extern "C" int dod_plucker_closest_per_ray(const void* g, const void* o, const void* d, void* t_out,
                                           void* idx_out, int n, int t_total, void* stream) {
  if (n <= 0) return 0;
  if (t_total < kPad || t_total % kPad) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRayThreads - 1) / kRayThreads);
  plucker_closest_per_ray_kernel<<<grid, kRayThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<float*>(t_out), static_cast<int*>(idx_out), n, t_total);
  return static_cast<int>(cudaGetLastError());
}

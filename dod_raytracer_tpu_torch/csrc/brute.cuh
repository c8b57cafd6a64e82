// Brute-force closest hit split over the triangle axis: the kernel template
// of mt_closest.cu (Möller–Trumbore) and plucker_closest.cu (Plücker).
// A Test policy gives the triangle's staged rows and the pair test; this
// header gives the grid, the staging ring, the merge and the measurement
// counts.  ops/brute.py holds the same split rule and the merge's plain
// version.
//
// Grid: (ray tiles, triangle splits).  A CTA of kThreads threads takes
// kCtaRays consecutive rays, kRays a thread: ray first + 32 r of lane
// `lane` in warp w, first = tile * kCtaRays + w * 32 kRays + lane, so the
// 32 lanes of a warp hold 32 consecutive rays in each of their kRays
// registers sets, and one staged triangle read serves kRays pairs.  Split
// s of S scans tiles [s * tiles / S, (s + 1) * tiles / S) of the
// t_total / kTile tiles in index order with a strict <, so each split
// keeps its lowest index at a tie.
//
// Staging: tile k of the unchanged global rows (kRows rows of t_total
// floats) is copied by 4-byte cp.async into kQuads float4 per triangle,
// into a ring of two slots, so tile k + 1 arrives while tile k is scanned;
// every lane then reads a triangle as kQuads broadcast 16-byte loads.
// Thread c copies column c of every row, so after its copies land it
// knows whether triangle c of the tile is all zero; the tile is scanned
// up to its last triangle with a non-zero row.  A triangle whose rows are
// all zero (swizzle_tris' and plucker_pack's padding) never hits: both
// tests need a non-zero determinant or edge side.  So the scan stops at
// the real triangle count without being told it.
//
// Merge: with one split each thread writes its rays' (t, idx).  With more,
// a thread whose split found a hit does one atomicMin on the ray's 64-bit
// key (bits(t) << 32) | idx, which starts at (bits(+inf) << 32) | 0 (the
// caller fills it), and unpack_kernel writes (t, idx) after.  A hit has
// t > 0, so its bits order as the float: the least key is the least t and,
// at equal t, the lowest index, which is what one scan in index order
// keeps.  A ray no split hit keeps (inf, 0), and the minimum does not
// depend on the order the CTAs finish in.
//
// Measurement (kStats, `stats` set, (2, kStages) uint64 zeroed by the
// caller): row 0 counts warp-steps (a warp's 32 rays of one register set
// against one triangle) by the deepest stage any of its lanes reached,
// row 1 pairs of rays < n by the stage they stopped at.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace brute {
namespace {

constexpr int kThreads = 128;               // 4 warps a CTA
constexpr int kRays = 2;                    // rays a thread
constexpr int kCtaRays = kThreads * kRays;  // ops/brute.py RAYS_PER_CTA
constexpr int kTile = 128;                  // triangles a tile (= kThreads), ops/brute.py TILE
constexpr int kPad = 512;                   // t_total is a multiple of it (ops/mt.py, ops/plucker.py TILE_T)
constexpr int kStages = 4;                  // the exits of a pair test; the last: the whole test
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTile == kThreads, "thread c stages and checks column c of a tile");

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// a and b are both > 0 or both < 0 (false for a zero or a NaN)
__device__ __forceinline__ bool same_sign(float a, float b) {
  return (a > 0.0f && b > 0.0f) || (a < 0.0f && b < 0.0f);
}

// Copy tile `tile` into dst: thread c copies column c of every row.
template <class Test>
__device__ __forceinline__ void stage(float4* dst, const float* rows, int tile, int t_total) {
  const float* src = rows + static_cast<size_t>(tile) * kTile + threadIdx.x;
  float* col = reinterpret_cast<float*>(dst + threadIdx.x * Test::kQuads);
#pragma unroll
  for (int row = 0; row < Test::kRows; ++row)
    cp_async4(col + Test::slot(row), src + static_cast<size_t>(Test::source_row(row)) * t_total);
  cp_async_commit();
}

// 1 + this thread's column of the staged tile if any of its rows is not
// zero, else 0 (reads back this thread's own landed copies).
template <class Test>
__device__ __forceinline__ int live_column(const float4* tile) {
  const float* col = reinterpret_cast<const float*>(tile + threadIdx.x * Test::kQuads);
  bool any = false;
#pragma unroll
  for (int row = 0; row < Test::kRows; ++row) any |= col[Test::slot(row)] != 0.0f;
  return any ? static_cast<int>(threadIdx.x) + 1 : 0;
}

template <class Test, bool kSplit, bool kStats>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ rows, const float* __restrict__ o, const float* __restrict__ d,
               float* __restrict__ t_out, int* __restrict__ idx_out, unsigned long long* __restrict__ keys,
               unsigned long long* __restrict__ stats, int n, int t_total) {
  __shared__ __align__(16) float4 ring[2][kTile * Test::kQuads];
  __shared__ int live[2];  // each slot's scan length
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kCtaRays + (threadIdx.x >> 5) * 32 * kRays + lane;
  typename Test::Ray ray[kRays];
  float best[kRays];
  int best_idx[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + 32 * r;
    ray[r] = Test::load(o, d, i < n ? i : -1);  // a ray past n is all zero and never hits
    best[r] = INFINITY;
    best_idx[r] = 0;
  }
  unsigned pairs[kStages] = {}, steps[kStages] = {};

  const int tiles = t_total / kTile;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.y) * tiles / gridDim.y);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * tiles / gridDim.y);
  if (threadIdx.x < 2) live[threadIdx.x] = 0;
  __syncthreads();
  stage<Test>(ring[0], rows, t0, t_total);
  for (int k = t0; k < t1; ++k) {
    const int s = (k - t0) & 1;
    if (k + 1 < t1) {  // the other slot was freed by the last barrier
      if (threadIdx.x == 0) live[s ^ 1] = 0;
      stage<Test>(ring[s ^ 1], rows, k + 1, t_total);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int mine = __reduce_max_sync(kFull, live_column<Test>(ring[s]));
    if (lane == 0 && mine) atomicMax(&live[s], mine);
    __syncthreads();  // the tile and its length are visible
    const int count = live[s];
    const float4* tile = ring[s];
    for (int j = 0; j < count; ++j) {
      int reached[kRays];
      Test::template pairs<kStats>(tile + j * Test::kQuads, ray, best, best_idx, k * kTile + j, reached);
      if (kStats) {
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          const bool on = first + 32 * r < n;
          const int deepest = __reduce_max_sync(kFull, on ? reached[r] : -1);
#pragma unroll
          for (int q = 0; q < kStages; ++q) {
            pairs[q] += on && reached[r] == q;
            steps[q] += deepest == q;
          }
        }
      }
    }
    __syncthreads();  // done with this slot
  }

#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + 32 * r;
    if (i >= n) continue;
    if (!kSplit) {
      t_out[i] = best[r];
      idx_out[i] = best_idx[r];
    } else if (best[r] < INFINITY) {  // a split with no hit leaves the key alone
      atomicMin(keys + i, (static_cast<unsigned long long>(__float_as_uint(best[r])) << 32) |
                              static_cast<unsigned>(best_idx[r]));
    }
  }
  if (kStats) {
#pragma unroll
    for (int q = 0; q < kStages; ++q) {
      const unsigned p = __reduce_add_sync(kFull, pairs[q]);
      if (lane == 0) {
        atomicAdd(stats + q, static_cast<unsigned long long>(steps[q]));
        atomicAdd(stats + kStages + q, static_cast<unsigned long long>(p));
      }
    }
  }
}

// (t, idx) of each ray from its merged key
__global__ void unpack_kernel(const unsigned long long* __restrict__ keys, float* __restrict__ t_out,
                              int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  t_out[i] = __uint_as_float(static_cast<unsigned>(key >> 32));
  idx_out[i] = static_cast<int>(static_cast<unsigned>(key));
}

// One wrapper call: the split kernel, then with splits > 1 the unpack.
// `keys` (n uint64 holding (bits(+inf) << 32) | 0) is needed for splits
// > 1, `stats` only for measurement.
template <class Test>
int launch(const void* rows, const void* o, const void* d, void* t_out, void* idx_out, void* keys,
           void* stats, int n, int t_total, int splits, void* stream) {
  if (n <= 0) return 0;
  if (t_total < kPad || t_total % kPad) return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > t_total / kTile || splits > 65535 || (splits > 1 && !keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = splits > 1;
  auto kernel = split ? (stats ? closest_kernel<Test, true, true> : closest_kernel<Test, true, false>)
                      : (stats ? closest_kernel<Test, false, true> : closest_kernel<Test, false, false>);
  const dim3 grid((n + kCtaRays - 1) / kCtaRays, splits);
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(rows), static_cast<const float*>(o),
                                   static_cast<const float*>(d), static_cast<float*>(t_out),
                                   static_cast<int*>(idx_out), static_cast<unsigned long long*>(keys),
                                   static_cast<unsigned long long*>(stats), n, t_total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  unpack_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const unsigned long long*>(keys),
                                                static_cast<float*>(t_out), static_cast<int*>(idx_out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace brute

// Binned leaf stage for the H100 (sm_90a): the closest hit of each ray in
// the one leaf block its key names.
//
// Replaces: dod_raytracer_tpu/ops/pallas/block_loop_kernel.py,
// block_loop_intersect / _kernel.  Same inputs (rays, one block key per ray,
// block_g, block_orig), plus the kd tables' block_tris rows, and the same
// outputs: per ray the first strict-minimum hit of its block, t and the
// original triangle id, and (inf, 2**30) for a key outside [0, B) or a block
// with no hit.  ops/binned.py binned_traverse calls it once per round of the
// walk over every ray of the batch (keys -1 for rays with no block this
// round), as the JAX package's _traverse_binned calls its kernel.
//
// The leaf test is the warp walks' lane-spread test (kd_warp.cuh
// lane_spread_test): Plücker edge signs on rows 0-5 of block_g, then the
// Möller–Trumbore t on block_tris, each operation rounded on its own, so
// it computes kd_leaf.cuh test_block's result.  Its plain version is
// ops/traverse.py leaf_plain, so the binned walk gives traverse_plain's
// bits.  The TPU kernel's t is the Plücker num/den, which flips grazing
// self-hits of secondary rays (kd_leaf.cuh).
//
// What bounds it on this card: fp32 operations (33 per edge-sign test of a
// non-empty slot and per distance, PERF.md §6), since every ray with a key
// edge-tests all slots of its block; the unique bytes are a few MB.  The
// earlier per-ray design (block_loop_per_ray_kernel below) read a block's
// 18 edge rows through L1/L2 once per ray, 27.6 KB at spad 384, so it ran
// at 3-6% of the bound.
//
// Design, from the TPU kernel's algorithm with the warp walks' machinery:
// a CTA takes a fixed run of kCtaWarps * 32 consecutive rays (the TPU
// kernel's 256-ray tile), with no sort: the 8x128 screen-block order and
// the shadow sort make neighbours share blocks.  It loops over the
// distinct keys of its rays, smallest first.  Each distinct block's 18
// edge rows are staged once into shared memory by cp.async, into a ring of
// two slots, so the next key's copy overlaps the current key's test; then
// every warp tests its lanes that name the block with the lane-spread test
// (a block wanted by w lanes of a warp costs w * spad / 128 iterations).
// Lanes with a key outside [0, B) take no part but stay in every
// collective.  The ring is shared by the CTA's warps, 55 KB at spad 384, so
// four CTAs (32 warps) fit an SM.  A ring per warp was measured against it
// and lost on every launch (PERF.md §6 gives the distinct keys per warp and
// per CTA and both designs' times).
//
// C entry points launch on the given stream and return cudaGetLastError();
// they allocate nothing and do not synchronize.  `stats`, `touched` and
// `key_counts` are for measurement only and null on the render path: when
// `stats` is set, a separate instantiation (kStats) writes per ray
// [non-empty slots edge-tested, slots whose distance was computed], marks
// in `touched` (B, 2 + slots), when it is set, the blocks edge-tested
// (column 1) and the slots whose triangle row was read (column 2 + j), and
// adds to `key_counts`, when it is set, [warps with a key, distinct keys
// summed over warps, CTAs with a key, distinct keys summed over CTAs].

#include "kd_leaf.cuh"
#include "kd_warp.cuh"

namespace {

using kdwarp::kFull;
using kdwarp::kNoSlot;

constexpr int kNoHit = 1 << 30;        // block_loop_kernel.py _BIG_I
constexpr unsigned kNone = 0xffffffffu;  // no key
constexpr int kWarps = 8;              // a CTA: 256 rays share one ring
constexpr int kRing = 2;               // staged blocks a ring holds

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage block blk's 18 edge rows (rows 0-5 of sections s0..s2) into dst as
// (6, 3, spad) floats, 16 bytes a thread of the CTA at a time; then commit
// the copy as one group.
__device__ __forceinline__ void stage(float* dst, const float* g, unsigned blk, int spad) {
  const float* src = g + static_cast<size_t>(blk) * 16 * 5 * spad;
  const int pieces = 3 * spad / 4;  // 16-byte pieces of one row's s0..s2
  for (int q = threadIdx.x; q < 6 * pieces; q += kWarps * 32) {
    const int k = q / pieces, p = q - k * pieces;
    kdwarp::cp_async16(dst + k * 3 * spad + 4 * p, src + static_cast<size_t>(k) * 5 * spad + 4 * p);
  }
  kdwarp::cp_async_commit();
}

// The smallest of the CTA's values v (kNone: none), in every thread,
// reduced through red.
__device__ __forceinline__ unsigned cta_min(unsigned v, unsigned* red, int lane, int warp) {
  unsigned m = __reduce_min_sync(kFull, v);
  if (lane == 0) red[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = min(m, red[w]);
  __syncthreads();
  return m;
}

// The loop over the CTA's distinct keys, smallest first.
template <bool kStats>
__global__ void __launch_bounds__(kWarps * 32, 4)
block_loop_kernel(const float* __restrict__ g, const float* __restrict__ tris,
                  const int* __restrict__ orig, const int* __restrict__ keys,
                  const float* __restrict__ o_in, const float* __restrict__ d_in,
                  float* __restrict__ t_out, int* __restrict__ prim_out,
                  int* __restrict__ stats, int* __restrict__ touched,
                  int* __restrict__ key_counts, int n, int num_blocks, int slots, int spad) {
  extern __shared__ __align__(16) float ring[];
  __shared__ unsigned red[kWarps];  // each warp's smallest key
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps * 32 + threadIdx.x;
  const int key = i < n ? keys[i] : -1;
  const unsigned k = key >= 0 && key < num_blocks ? static_cast<unsigned>(key) : kNone;

  float3 o = make_float3(0.f, 0.f, 0.f), d = make_float3(0.f, 0.f, 1.f);
  if (k != kNone) {
    o = make_float3(o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]);
    d = make_float3(d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]);
  }
  float r[6];
  kdleaf::plucker_row(o, d, r);

  const int ring_floats = 18 * spad;
  float best = INFINITY;
  int prim = kNoHit;
  int work[2] = {0, 0};
  int warp_keys = 0, cta_keys = 0;
  unsigned cur = cta_min(k, red, lane, warp);
  if (cur != kNone) stage(ring, g, cur, spad);
  unsigned nxt = cur != kNone ? cta_min(k != kNone && k > cur ? k : kNone, red, lane, warp) : kNone;
  int slot = 0;
  while (cur != kNone) {  // uniform over the CTA
    // stage the next key into the other slot, then wait for this key's rows
    if (nxt != kNone) {
      stage(ring + (slot ^ 1) * ring_floats, g, nxt, spad);
      cp_async_wait_one();
    } else {
      kdwarp::cp_async_wait_all();
    }
    // the key after nxt: this warp's part now, the CTA's after the barrier
    unsigned after = __reduce_min_sync(kFull, nxt != kNone && k != kNone && k > nxt ? k : kNone);
    if (lane == 0) red[warp] = after;
    __syncthreads();  // the staged rows and red are visible
#pragma unroll
    for (int w = 0; w < kWarps; ++w) after = min(after, red[w]);

    unsigned want = __ballot_sync(kFull, k == cur);
    if (kStats) {
      ++cta_keys;
      warp_keys += want != 0;
    }
    if (want) {
      const kdleaf::SharedRows rows{ring + slot * ring_floats, spad};
      const float* tb = tris + static_cast<size_t>(cur) * slots * 9;
      const int* ob = orig + static_cast<size_t>(cur) * slots;
      int* marks = kStats && touched ? touched + static_cast<size_t>(cur) * (2 + slots) : nullptr;
      int nonempty = 0;
      if (kStats) {
        for (int j = lane; j < slots; j += 32) nonempty += __ldg(ob + j) >= 0;
        nonempty = __reduce_add_sync(kFull, nonempty);
        if (marks && lane == 0) marks[1] = 1;
      }
      while (want) {
        const int src = __ffs(want) - 1;
        want &= want - 1;
        float rr[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) rr[q] = __shfl_sync(kFull, r[q], src);
        const float3 oo = kdwarp::shfl3(o, src), dd = kdwarp::shfl3(d, src);
        float bt = INFINITY;
        int distances = 0;
        const int bj = kdwarp::lane_spread_test<false>(rows, tb, slots, lane, rr, oo, dd, bt, [&](int j) {
          if (kStats) {
            ++distances;
            if (marks) marks[2 + j] = 1;
          }
        });
        if (kStats) distances = __reduce_add_sync(kFull, distances);
        if (lane == src) {
          if (bj != kNoSlot) {
            best = bt;
            prim = __ldg(ob + bj);
          }
          if (kStats) {
            work[0] = nonempty;
            work[1] = distances;
          }
        }
      }
    }
    __syncthreads();  // done with this slot and red
    cur = nxt;
    nxt = after;
    slot ^= 1;
  }

  if (i < n) {
    t_out[i] = best;
    prim_out[i] = prim;
    if (kStats) {
      stats[2 * i] = work[0];
      stats[2 * i + 1] = work[1];
    }
  }
  if (kStats && key_counts) {
    if (lane == 0 && warp_keys) {
      atomicAdd(key_counts, 1);
      atomicAdd(key_counts + 1, warp_keys);
    }
    if (threadIdx.x == 0 && cta_keys) {
      atomicAdd(key_counts + 2, 1);
      atomicAdd(key_counts + 3, cta_keys);
    }
  }
}

// ---------------------------------------------------------------------------
// The per-ray kernel this one replaced, for measurement only: one thread
// per ray, 128 threads a block, the block's rows read through __ldg
// (kd_leaf.cuh test_block).

constexpr int kRayThreads = 128;

template <bool kStats>
__global__ void __launch_bounds__(kRayThreads)
block_loop_per_ray_kernel(const float* __restrict__ g, const float* __restrict__ tris,
                          const int* __restrict__ orig, const int* __restrict__ keys,
                          const float* __restrict__ o_in, const float* __restrict__ d_in,
                          float* __restrict__ t_out, int* __restrict__ prim_out,
                          int* __restrict__ stats, int* __restrict__ touched, int n,
                          int num_blocks, int slots, int spad) {
  const int i = blockIdx.x * kRayThreads + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  float best = INFINITY;
  int prim = kNoHit;
  int work[2] = {0, 0};
  if (key >= 0 && key < num_blocks) {
    const float3 o = make_float3(o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]);
    const float3 d = make_float3(d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]);
    float r[6];
    kdleaf::plucker_row(o, d, r);
    const size_t blk = static_cast<size_t>(key);
    int* marks = kStats && touched ? touched + blk * (2 + slots) : nullptr;
    const int j = kdleaf::test_block<false, kStats>(
        g + blk * 16 * 5 * spad, tris + blk * slots * 9, orig + blk * slots, slots,
        spad, r, o, d, best, work, marks);
    if (j >= 0) prim = __ldg(orig + blk * slots + j);
  }
  t_out[i] = best;
  prim_out[i] = prim;
  if (kStats) {
    stats[2 * i] = work[0];
    stats[2 * i + 1] = work[1];
  }
}

template <bool kStats>
int launch(const void* g, const void* tris, const void* orig, const void* keys, const void* o,
           const void* d, void* t_out, void* prim_out, void* stats, void* touched, void* key_counts,
           int n, int num_blocks, int slots, int spad, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kRing) * 18 * spad * sizeof(float);
  if (smem > static_cast<size_t>(kdwarp::kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = block_loop_kernel<kStats>;
  // above 48 KB a launch is refused unless the kernel is allowed more first
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kWarps * 32 - 1) / (kWarps * 32));
  kernel<<<grid, kWarps * 32, smem, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(tris),
      static_cast<const int*>(orig), static_cast<const int*>(keys),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<float*>(t_out), static_cast<int*>(prim_out), static_cast<int*>(stats),
      static_cast<int*>(touched), static_cast<int*>(key_counts), n, num_blocks, slots, spad);
  return static_cast<int>(cudaGetLastError());
}

// What the staged kernel needs: 4 slots a 16-byte load, block_g 16-byte aligned.
bool fits(const void* g, int num_blocks, int slots, int spad) {
  return num_blocks >= 1 && slots >= 1 && spad >= slots && slots % 4 == 0 && spad % 4 == 0 &&
         reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

}  // namespace

// The render path's kernel.
extern "C" int dod_block_loop(const void* g, const void* tris, const void* orig,
                              const void* keys, const void* o, const void* d,
                              void* t_out, void* prim_out, void* stats, void* touched,
                              void* key_counts, int n, int num_blocks, int slots, int spad,
                              void* stream) {
  if (n <= 0) return 0;
  if (!fits(g, num_blocks, slots, spad)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fn = stats ? launch<true> : launch<false>;
  return fn(g, tris, orig, keys, o, d, t_out, prim_out, stats, touched, key_counts, n, num_blocks,
            slots, spad, s);
}

// The per-ray kernel it replaced (measurement only).
extern "C" int dod_block_loop_per_ray(const void* g, const void* tris, const void* orig,
                                      const void* keys, const void* o, const void* d,
                                      void* t_out, void* prim_out, void* stats, void* touched,
                                      int n, int num_blocks, int slots, int spad, void* stream) {
  if (n <= 0) return 0;
  if (num_blocks < 1 || slots < 1 || spad < slots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kRayThreads - 1) / kRayThreads);
  auto kernel = stats ? block_loop_per_ray_kernel<true> : block_loop_per_ray_kernel<false>;
  kernel<<<grid, kRayThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(tris),
      static_cast<const int*>(orig), static_cast<const int*>(keys),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<float*>(t_out), static_cast<int*>(prim_out), static_cast<int*>(stats),
      static_cast<int*>(touched), n, num_blocks, slots, spad);
  return static_cast<int>(cudaGetLastError());
}

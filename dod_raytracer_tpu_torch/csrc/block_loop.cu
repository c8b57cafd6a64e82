// Binned leaf stage for the H100 (sm_90a): the closest hit of each ray in
// the one leaf block its key names.
//
// Replaces: dod_raytracer_tpu/ops/pallas/block_loop_kernel.py,
// block_loop_intersect / _kernel.  Same inputs (rays, one block key per ray,
// block_g, block_orig), plus the kd tables' block_tris rows, and the same
// outputs: per ray the first strict-minimum hit of its block, t and the
// original triangle id, and (inf, 2**30) for a key outside [0, B) or a block
// with no hit.  ops/binned.py binned_traverse calls it once per round of the
// lockstep walk, as the JAX package's _traverse_binned calls its kernel.
//
// The leaf test is kd_leaf.cuh test_block, the one the packet, mega and
// forest kernels run: Plücker edge signs on rows 0-5 of block_g, then the
// Möller–Trumbore t on block_tris, each operation rounded on its own.  Its
// plain version is ops/traverse.py leaf_plain, so the binned walk gives
// traverse_plain's bits.  The TPU kernel's t is the Plücker num/den, which
// flips grazing self-hits of secondary rays (kd_leaf.cuh).
//
// What bounds it on this card: neither HBM bytes nor fp32 throughput.  Each
// ray reads 28 bytes and writes 8, then edge-tests the slots of one block
// (384 on the flagship trees, 33 fp32 operations each) from block_g, read
// through L2 by every ray that names the block.  Rays of a warp that name
// different blocks read different rows.
//
// Design (simple first): one thread per ray, 128 threads per block.  The
// TPU kernel's per-tile loop over distinct keys, its DMA of each block into
// VMEM and its 16-wide MXU rows are that machine's layout, not the
// function: each GPU thread reads its own block through __ldg.
//
// C entry point: dod_block_loop(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not
// synchronize.  `stats` and `touched` are for measurement only and null on
// the render path; when `stats` is set, a separate instantiation (kStats)
// writes per ray [non-empty slots edge-tested, slots whose distance was
// computed] and marks in `touched` (B, 2 + slots), when it is set, the
// blocks edge-tested (column 1) and the slots whose triangle row was read
// (column 2 + j).

#include "kd_leaf.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNoHit = 1 << 30;  // block_loop_kernel.py _BIG_I

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
block_loop_kernel(const float* __restrict__ g, const float* __restrict__ tris,
                  const int* __restrict__ orig, const int* __restrict__ keys,
                  const float* __restrict__ o_in, const float* __restrict__ d_in,
                  float* __restrict__ t_out, int* __restrict__ prim_out,
                  int* __restrict__ stats, int* __restrict__ touched, int n,
                  int num_blocks, int slots, int spad) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
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

}  // namespace

extern "C" int dod_block_loop(const void* g, const void* tris, const void* orig,
                              const void* keys, const void* o, const void* d,
                              void* t_out, void* prim_out, void* stats, void* touched,
                              int n, int num_blocks, int slots, int spad, void* stream) {
  if (n <= 0) return 0;
  if (num_blocks < 1 || slots < 1 || spad < slots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreads - 1) / kThreads);
  auto kernel = stats ? block_loop_kernel<true> : block_loop_kernel<false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(tris),
      static_cast<const int*>(orig), static_cast<const int*>(keys),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<float*>(t_out), static_cast<int*>(prim_out), static_cast<int*>(stats),
      static_cast<int*>(touched), n, num_blocks, slots, spad);
  return static_cast<int>(cudaGetLastError());
}

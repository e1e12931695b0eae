// Inclusive prefix sums of the rows of a float32 matrix in a fixed order of
// additions: out[r, i] = x[r, 0] + ... + x[r, i], the same bits at every call
// on the same input.
//
// A port-only kernel: it replaces no Pallas kernel. The JAX package takes
// the area CDF of its surface sampling with jnp.cumsum
// (d3human_tpu/ops/mesh_ops.py:168 sample_points_on_mesh) and the light
// probe's sampling tables with jnp.cumsum along an axis
// (d3human_tpu/render/light.py update_pdf), which XLA runs in a fixed
// order. torch.cumsum on a CUDA float tensor is a one-pass scan
// with a decoupled look-back: a tile adds the prefixes of whichever tiles
// before it have finished, so the order of additions, and the rounding,
// changes from run to run (PyTorch lists it as nondeterministic on CUDA).
// The CDF picks the face of every eikonal sample, so one changed rounding
// can move a sample to another face.
//
// Bound on the card: bytes. The answer needs x read once and out written
// once, 8 B an entry: 6.3 MB for the 786,432 faces of the f3c extraction,
// 0.0019 ms at 3.35 TB/s, less than a launch's latency.
//
// Design: two launches, a row of the grid a row of the matrix, no atomics,
// no spin-wait, no scratch to zero; every sum is taken in double in an order
// fixed by n alone, so the result is
// near the exact prefix rounded once to float (the CPU's torch.cumsum also
// accumulates a float input in double).
//   scan_tile_sum_kernel  one CTA a tile of TILE entries of a row: each
//       thread adds its ITEMS consecutive entries in order, then a tree over
//       the threads -> tile_sums[row, tile] (double).
//   scan_tile_kernel      one CTA a tile: the tree sum of tile_sums[row, 0,
//       tile) (each thread adds every THREADS-th one in order, then a tree),
//       the thread's running sums of its entries, a Hillis-Steele scan of
//       the threads' totals in shared memory, out = float(offset + before +
//       running sum).
// A CTA of the second launch reads all the tile sums before it: at the
// f3c extraction that is 384 tiles, 8 B each, from L2; the work grows with
// the square of the tile count only far beyond the main path's sizes.
// Loads and stores go through shared memory, so neighbouring threads touch
// neighbouring addresses in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256              // threads of a CTA
#define ITEMS 8                  // consecutive entries a thread
#define TILE (THREADS * ITEMS)   // entries per CTA: 2,048

// the tree sum of v over the CTA (fixed pairing), returned to every thread
__device__ __forceinline__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const double total = sh[0];
  __syncthreads();
  return total;
}

// the tile's entries of the row x into shared memory (coalesced), zero
// past n
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          long long n, float* tile) {
  const long long t0 = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = j * THREADS + threadIdx.x;
    tile[q] = t0 + q < n ? x[t0 + q] : 0.0f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    scan_tile_sum_kernel(const float* __restrict__ x, long long n,
                         double* __restrict__ tile_sums) {
  __shared__ float tile[TILE];
  __shared__ double sh[THREADS];
  load_tile(x + (long long)blockIdx.y * n, n, tile);
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) acc += (double)tile[threadIdx.x * ITEMS + j];
  const double total = block_sum(acc, sh);
  if (threadIdx.x == 0)
    tile_sums[(long long)blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
    scan_tile_kernel(const float* __restrict__ x, long long n,
                     const double* __restrict__ tile_sums,
                     float* __restrict__ out) {
  __shared__ float tile[TILE];
  __shared__ double sh[THREADS];
  __shared__ double scan[2][THREADS];
  const long long row = (long long)blockIdx.y * n;
  tile_sums += (long long)blockIdx.y * gridDim.x;
  // the sum of the row's tiles before this one
  double before = 0.0;
  for (unsigned b = threadIdx.x; b < blockIdx.x; b += THREADS)
    before += tile_sums[b];
  const double offset = block_sum(before, sh);

  load_tile(x + row, n, tile);
  double run[ITEMS];
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    acc += (double)tile[threadIdx.x * ITEMS + j];
    run[j] = acc;
  }
  // inclusive Hillis-Steele scan of the threads' totals (ping-pong buffers)
  int cur = 0;
  scan[cur][threadIdx.x] = acc;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {
    const double v = scan[cur][threadIdx.x];
    scan[cur ^ 1][threadIdx.x] =
        threadIdx.x >= d ? scan[cur][threadIdx.x - d] + v : v;
    cur ^= 1;
    __syncthreads();
  }
  // the threads before this one, read from the scan (not its inclusive
  // value less acc, which would round)
  const double prior = threadIdx.x == 0 ? 0.0 : scan[cur][threadIdx.x - 1];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    tile[threadIdx.x * ITEMS + j] = (float)(offset + (prior + run[j]));
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = j * THREADS + threadIdx.x;
    if (t0 + q < n) out[row + t0 + q] = tile[q];
  }
}

// x, out: float32 [rows, n] contiguous, 0 < n < 2^31 * TILE, 0 < rows <
// 65,536; tile_sums: double scratch of rows * ceil(n / TILE) entries,
// written by the first launch before the second reads it. Returns the first
// launch error, else 0.
extern "C" int d3h_inclusive_scan(const void* x, int rows, long long n,
                                  void* tile_sums, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((n + TILE - 1) / TILE), (unsigned)rows);
  scan_tile_sum_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)x, n, (double*)tile_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tile_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)x, n, (const double*)tile_sums, (float*)out);
  return (int)cudaGetLastError();
}

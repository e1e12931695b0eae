// Stream compaction: the first k set entries of a 1-D mask, ascending,
// tail filled with fill (jnp.nonzero(mask, size=k, fill_value=fill)[0]).
//
// Replaces the Pallas TPU kernel d3human_tpu/ops/compaction.py:37
// _first_k_kernel (called from _first_k_pallas at :95). There each 512-slot
// output block streams its input range through VMEM and matches ranks to
// slots with a one-hot MXU matmul against an int32 cumsum taken outside the
// kernel; positions ride through f32, hence the JAX path's n < 2^24 limit.
// Here positions stay integers: n and k are bounded only by int32.
//
// Bound on the card: bytes. The answer needs the mask read once (1 B per
// entry) and k int32 slots written: 4.6 MB + 1 MB at the crossing edges of
// the f3c lattice, 0.0017 ms at 3.35 TB/s, less than one launch's latency.
//
// Design: count, then write. Two launches, no scratch to zero, no spin-wait,
// the same integers whatever the order of the CTAs, and nothing carried from
// one call to the next, so a CUDA graph can replay it. A one-pass scan with
// a decoupled look-back would save a launch but needs a status array zeroed
// at every call (a memset launch) and CTAs that spin on each other; the
// masks of the main path are one wave of tiles, so it buys little. The mask
// is cut into tiles of TILE_BYTES bytes, one CTA each, read with 16-byte
// loads, neighbouring threads on neighbouring addresses; n = 4.6 M is 283
// tiles, one wave over 132 SMs.
//   first_k_count_kernel  the tile's count of nonzero bytes -> counts[tile].
//   first_k_write_kernel  launched as a programmatic dependent launch: its
//       CTAs start while the count grid runs and read their tile again (the
//       4.6 MB stay in the 50 MB L2), then wait for the count grid to end
//       (griddepcontrol.wait). The sum of the counts before the tile (a few
//       hundred ints from L2) is the tile's first rank, the sum of all of
//       them the total. The CTA ranks its set bytes with a block scan of the
//       threads' counts and writes out[rank] = index for every rank < k; a
//       tile whose first rank is >= k writes nothing. Every CTA also writes
//       its share of the fill slots [total, k).
// The early start hides the second launch's latency behind the first.
// A CTA of the second launch sums all the counts (4 B per tile): at the
// largest mask of the main path that is 283 ints, and it grows with the
// square of the tile count only for masks far beyond the path's.
//
// The int32 cumsum went. The earlier wrapper took torch.cumsum of the mask
// (an int32 copy and a multi-kernel library scan, some 60 MB moved for a
// 4.6 MB mask, about four launches) and the kernel read it at every set
// entry; a rank is needed only at a set entry below k, and the tile counts
// give it. A mask that does not start on 16 bytes (a view at an offset) and
// its ragged end are read byte by byte in the 16-byte pieces that hold
// them: positions q run from the 16-byte line below the mask's first byte,
// and the mask's bytes are q in [lo, hi).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256                       // threads of a CTA
#define VECS 4                            // 16-byte pieces a thread per tile
#define TILE_BYTES (THREADS * VECS * 16)  // mask bytes per CTA: 16,384
#define FILL_SLOTS 8192                   // fill slots per CTA at the least
#define WARPS (THREADS / 32)
#define FULL 0xffffffffu

// one bit per nonzero byte of w, byte 0 -> bit 0
__device__ __forceinline__ unsigned word_bits(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ unsigned vec_bits(uint4 v) {
  return word_bits(v.x) | word_bits(v.y) << 4 | word_bits(v.z) << 8 |
         word_bits(v.w) << 12;
}

// The 16 bits of the piece at q0 (a multiple of 16) of every thread, VECS
// pieces THREADS * 16 bytes apart: vector loads where the whole tile lies in
// [lo, hi), else byte by byte inside it.
__device__ __forceinline__ void tile_bits(const uint8_t* __restrict__ base,
                                          long long q0, long long lo,
                                          long long hi, unsigned* bits) {
  const long long t0 = (long long)blockIdx.x * TILE_BYTES;
  if (t0 >= lo && t0 + TILE_BYTES <= hi) {
    uint4 v[VECS];
#pragma unroll
    for (int j = 0; j < VECS; ++j)
      v[j] = *reinterpret_cast<const uint4*>(base + q0 + j * THREADS * 16);
#pragma unroll
    for (int j = 0; j < VECS; ++j) bits[j] = vec_bits(v[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const long long p = q0 + j * THREADS * 16;
    unsigned b = 0;
    if (p >= lo && p + 16 <= hi) {
      b = vec_bits(*reinterpret_cast<const uint4*>(base + p));
    } else {
      for (int i = 0; i < 16; ++i)
        if (p + i >= lo && p + i < hi && base[p + i]) b |= 1u << i;
    }
    bits[j] = b;
  }
}

__global__ void __launch_bounds__(THREADS)
first_k_count_kernel(const uint8_t* __restrict__ base, long long lo,
                     long long hi, int* __restrict__ counts) {
  __shared__ int warp_sum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the write launch may start now: it reads the counts only after this
  // grid has finished (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");
  unsigned bits[VECS];
  tile_bits(base, (long long)blockIdx.x * TILE_BYTES + threadIdx.x * 16, lo,
            hi, bits);
  int c = 0;
#pragma unroll
  for (int j = 0; j < VECS; ++j) c += __popc(bits[j]);
  c = __reduce_add_sync(FULL, c);
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_sum[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
first_k_write_kernel(const uint8_t* __restrict__ base, long long lo,
                     long long hi, const int* __restrict__ counts, int tiles,
                     int k, int fill, int32_t* __restrict__ out) {
  __shared__ int warp_sum[2][WARPS];
  __shared__ unsigned long long warp_scan[WARPS];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)tile * TILE_BYTES + threadIdx.x * 16;

  // the tile's bytes do not depend on the count launch: load them while it
  // runs, then wait for its counts
  unsigned bits[VECS] = {};
  if (tile < tiles) tile_bits(base, q0, lo, hi, bits);
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // the tile's first rank and the whole mask's count
  int before = 0, total = 0;
  for (int i = threadIdx.x; i < tiles; i += THREADS) {
    const int c = counts[i];
    total += c;
    if (i < tile) before += c;
  }
  before = __reduce_add_sync(FULL, before);
  total = __reduce_add_sync(FULL, total);
  if (lane == 0) {
    warp_sum[0][warp] = before;
    warp_sum[1][warp] = total;
  }
  __syncthreads();
  before = total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += warp_sum[0][w];
    total += warp_sum[1][w];
  }

  // this CTA's share of the fill slots [total, k)
  for (long long s = (long long)total + (long long)blockIdx.x * THREADS +
                     threadIdx.x;
       s < k; s += (long long)gridDim.x * THREADS)
    out[s] = fill;

  // uniform over the CTA: no rank of this tile lands, or it has none
  if (tile >= tiles || before >= k || counts[tile] == 0) return;

  // exclusive scan over the CTA of the threads' counts, piece j's count in
  // bits [16j, 16j + 16) (a piece's sum over the CTA is at most 4,096)
  unsigned long long v = 0;
#pragma unroll
  for (int j = 0; j < VECS; ++j)
    v |= (unsigned long long)__popc(bits[j]) << (16 * j);
  unsigned long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_scan[warp] = inc;
  __syncthreads();
  unsigned long long excl = inc - v, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) excl += warp_scan[w];
    all += warp_scan[w];
  }

  // piece j of every thread comes after pieces 0..j-1 of all threads
  int first = before;
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    int r = first + (int)((excl >> (16 * j)) & 0xffff);
    const int idx0 = (int)(q0 + j * THREADS * 16 - lo);
    for (unsigned b = bits[j]; b && r < k; b &= b - 1)
      out[r++] = idx0 + __ffs(b) - 1;
    first += (int)((all >> (16 * j)) & 0xffff);
  }
}

// mask: n bytes, nonzero = set (bool or uint8), any alignment; out: int32
// [k]; counts: int32 scratch of at least ceil((n + 15) / TILE_BYTES) entries,
// written by the first launch before the second reads it. 0 < n < 2^31,
// 0 < k < 2^31. Returns the first launch error, else 0.
extern "C" int d3h_first_k(const void* mask, long long n, int k, int fill,
                           void* out, void* counts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long lo = (long long)((uintptr_t)mask & 15);
  const uint8_t* base = (const uint8_t*)mask - lo;
  const long long hi = lo + n;
  const long long tiles = (hi + TILE_BYTES - 1) / TILE_BYTES;
  first_k_count_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(base, lo, hi,
                                                           (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long fill_ctas = ((long long)k + FILL_SLOTS - 1) / FILL_SLOTS;
  const long long grid = tiles > fill_ctas ? tiles : fill_ctas;
  // programmatic dependent launch: the write grid is scheduled while the
  // count grid runs, and waits for it inside (griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, first_k_write_kernel, base, lo, hi,
                           (const int*)counts, (int)tiles, k, fill,
                           (int32_t*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

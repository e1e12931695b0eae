// Per-tile z-buffer resolve of the rasterizer.
//
// Replaces the Pallas TPU kernel d3human_tpu/ops/pallas_raster.py:64
// _resolve_body (via _resolve_kernel / _resolve_kernel_peel, called from
// resolve_tiles_pallas at :151). For every tile of th x tw pixels, each
// pixel centre is tested against the tile's M fused 16-float face rows
// [A0x A0y A1x A1y A2x A2y | C0 C1 C2 | az bz cz | live | pad3]; the pixel
// keeps the integer min of the packed key (zq << 10) | slot, zq the 21-bit
// quantized depth. With a floor (one depth-peel step) only keys strictly
// above the floor compete. The key format is kept bit for bit, so
// unpack_keys carries over.
//
// Bound on the card: operations (18 f32 operations per live slot and pixel,
// 19 with a floor, against 64 B of face row shared by a whole tile). What
// held the first kernel of this file at 80x that bound: it walked all M
// slots of every tile though 6 % are live, read rows that a PyTorch gather
// had first copied per slot (80 MB a render, 94 % of it the zero row), staged
// them with 4-byte loads in one buffer, and left the longest tile to one
// CTA. This design:
//
//  * Live ranges. The binning knows each tile's layout: slots [0, counts[t])
//    hold its own near-to-far list, slots [g0, g0 + *n_global) the shared
//    list of oversize faces, everything else is dead. The kernel walks those
//    two ranges only (counts == null: all M slots). It goes on testing each
//    row's live flag, and skips a dead row before any arithmetic (the flag
//    is uniform over the CTA). A tile with nothing to walk, or on a peel
//    step with every pixel's floor at MISS_KEY, writes MISS_KEY and leaves.
//  * Rows by index. With faces != null a slot's row is read from the face
//    table rows[faces[t, slot]] ([F+1, 16]), so the per-slot copy never
//    exists; with faces == null rows is that copy, [NT, M, 16].
//  * Vector staging, overlapped. A block of up to 128 rows is staged with
//    16-byte cp.async copies (a row is four) into one of two shared
//    buffers (16 KB): block k+1 arrives while block k is evaluated. TMA was
//    not taken: the pieces are at most 8 KB, of a length that differs per
//    tile, and in the indexed form not contiguous.
//  * PIX pixels of one column per thread (4, or 2 or 1 where 4 does not
//    divide th): a row is read from shared memory
//    once (four 16-byte broadcasts) for PIX pixels, and the px products of
//    the edge and depth functions are shared by them. The depth and the key
//    are formed only in a warp of which some pixel lies inside the face
//    (one vote); most faces cover none of a warp's 32 x PIX pixels. Testing
//    four rows between two branches instead of one measured 10 % slower.
//  * The tail. A tile's slots are cut into ranges of CHUNK = 128; grid.y
//    CTAs take one range each and combine with an integer atomicMin on the
//    key into an output filled with MISS_KEY. A minimum of integers does
//    not depend on order, so the keys stay exact and repeatable. With one
//    range (M == CHUNK) the key is stored directly and nothing is filled.
//    (Ranges of 256 to 1,024 slots and 8 pixels a thread measured slower.)
//
// No tensor cores: the Pallas kernel forms the edge functions as f32 MXU
// dots; the only f32-input tensor-core path of this card is TF32, whose 10
// mantissa bits would change keys. The arithmetic stays on the CUDA cores,
// written with explicit round-to-nearest intrinsics in the order the JAX
// kernel's dots evaluate (XLA's FMA chain acc = px*a; acc = fma(py, b, acc);
// then + c), so nvcc cannot contract it differently and keys agree bit for
// bit with the plain PyTorch version in ops/raster_resolve.py.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SLOT_BITS 10
#define ROW_W 16
#define BLOCK 128              // rows staged at once
#define CHUNK 128              // slots per CTA: M / CHUNK CTAs per tile
#define MISS_KEY 0x7fffffff

__global__ void fill_keys_kernel(int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = MISS_KEY;
}

template <int PIX>
__global__ void resolve_tiles_kernel(const float* __restrict__ rows,
                                     const int32_t* __restrict__ faces,
                                     const int32_t* __restrict__ floor_keys,
                                     const int32_t* __restrict__ counts,
                                     int g0,
                                     const int32_t* __restrict__ n_global,
                                     int m, int th, int tw, int ntx,
                                     int32_t* __restrict__ out) {
  __shared__ __align__(16) float srows[2][BLOCK * ROW_W];
  const int t = blockIdx.x;
  const int P = th * tw;
  const int col = threadIdx.x % tw;
  const int row0 = (threadIdx.x / tw) * PIX;
  const bool split = gridDim.y > 1;
  int32_t* o = out + (size_t)t * P + (size_t)row0 * tw + col;

  // this CTA's slots: [lo, hi) cut with the tile's two live ranges
  const int lo = blockIdx.y * CHUNK;
  const int hi = min(lo + CHUNK, m);
  int a0 = lo, a1 = hi, b0 = 0, b1 = 0;
  if (counts != nullptr) {
    a1 = min(hi, counts[t]);
    if (n_global != nullptr) {
      b0 = max(lo, g0);
      b1 = min(hi, g0 + *n_global);
    }
  }
  const int na = a1 > a0 ? (a1 - a0 + BLOCK - 1) / BLOCK : 0;
  const int nb = b1 > b0 ? (b1 - b0 + BLOCK - 1) / BLOCK : 0;
  const int nblk = na + nb;
  int floor_key[PIX], best[PIX];
  bool dead = nblk == 0;                 // nothing to walk ...
  if (!dead && floor_keys != nullptr) {  // ... or every floor at MISS_KEY
    dead = true;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      floor_key[k] = floor_keys[(size_t)t * P + (size_t)(row0 + k) * tw + col];
      dead = dead && floor_key[k] == MISS_KEY;
    }
    dead = __syncthreads_and(dead);
  }
  if (dead) {
    if (!split) {
#pragma unroll
      for (int k = 0; k < PIX; ++k) o[k * tw] = MISS_KEY;
    }
    return;
  }
  const float ox = (float)((t % ntx) * tw);
  const float oy = (float)((t / ntx) * th);
  const float px = __fadd_rn(__fadd_rn((float)col, 0.5f), ox);
  float py[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    py[k] = __fadd_rn(__fadd_rn((float)(row0 + k), 0.5f), oy);
    if (floor_keys == nullptr) floor_key[k] = 0;
    best[k] = MISS_KEY;
  }

  const float z_half = 1048575.5f;           // 0.5 * (2^21 - 1)
  const float z_scale = 2097151.0f;          // 2^21 - 1
  const size_t slot0 = (size_t)t * m;

  auto block_start = [&](int k) {
    return k < na ? a0 + k * BLOCK : b0 + (k - na) * BLOCK;
  };
  auto block_len = [&](int k) {
    return min(BLOCK, (k < na ? a1 : b1) - block_start(k));
  };
  auto stage = [&](int k) {
    const int start = block_start(k), len = block_len(k);
    float* dst = srows[k & 1];
    for (int i = threadIdx.x; i < len * 4; i += blockDim.x) {
      const size_t slot = slot0 + start + (i >> 2);
      const float* src = faces ? rows + (size_t)faces[slot] * ROW_W
                               : rows + slot * ROW_W;
      __pipeline_memcpy_async(dst + i * 4, src + (i & 3) * 4, 16);
    }
    __pipeline_commit();
  };

  stage(0);
  for (int k = 0; k < nblk; ++k) {
    if (k + 1 < nblk) {
      stage(k + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int start = block_start(k), len = block_len(k);
    const float4* r4 = (const float4*)srows[k & 1];
#pragma unroll 2
    for (int j = 0; j < len; ++j) {
      const float live = ((const float*)(r4 + 4 * j + 3))[0];
      if (!(live > 0.5f)) continue;          // uniform over the CTA
      const float4 ra = r4[4 * j];           // A0x A0y A1x A1y
      const float4 rb = r4[4 * j + 1];       // A2x A2y C0  C1
      const float4 rc = r4[4 * j + 2];       // C2  az  bz  cz
      const float m0 = __fmul_rn(px, ra.x);
      const float m1 = __fmul_rn(px, ra.z);
      const float m2 = __fmul_rn(px, rb.x);
      bool hit[PIX], any = false;
#pragma unroll
      for (int k2 = 0; k2 < PIX; ++k2) {
        const float e0 = __fadd_rn(__fmaf_rn(py[k2], ra.y, m0), rb.z);
        const float e1 = __fadd_rn(__fmaf_rn(py[k2], ra.w, m1), rb.w);
        const float e2 = __fadd_rn(__fmaf_rn(py[k2], rb.y, m2), rc.x);
        hit[k2] = (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) ||
                  (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f);
        any = any || hit[k2];
      }
      // most faces cover no pixel of a warp's 32 x PIX: the depth and the
      // key are formed only where one does
      if (!__any_sync(__activemask(), any)) continue;
      const float mz = __fmul_rn(px, rc.y);
      const int slot = start + j;
#pragma unroll
      for (int k2 = 0; k2 < PIX; ++k2) {
        const float z = __fadd_rn(__fmaf_rn(py[k2], rc.z, mz), rc.w);
        float zf = __fmul_rn(__fadd_rn(z, 1.0f), z_half);
        zf = fminf(fmaxf(zf, 0.0f), z_scale);
        int key = ((int)zf << SLOT_BITS) | slot;
        if (!hit[k2]) key = MISS_KEY;
        if (floor_keys && !(key > floor_key[k2])) key = MISS_KEY;
        best[k2] = key < best[k2] ? key : best[k2];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    if (!split) o[k * tw] = best[k];
    else if (best[k] != MISS_KEY) atomicMin(o + k * tw, best[k]);
  }
}

// rows: [NT, M, 16] per-slot rows (faces == null) or the face table
// [F+1, 16] read through faces [NT, M] int32. counts [NT] and *n_global
// bound the slots walked (null: all M).
extern "C" int d3h_resolve_tiles(const void* rows, const void* faces,
                                 const void* floor_keys, const void* counts,
                                 int g0, const void* n_global, int nt, int m,
                                 int th, int tw, int ntx, void* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned ny = (unsigned)((m + CHUNK - 1) / CHUNK);
  if (ny > 1) {
    const long long n = (long long)nt * th * tw;
    fill_keys_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        (int32_t*)out, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nt, ny);
  const int pix = th % 4 == 0 ? 4 : th % 2 == 0 ? 2 : 1;
  const int threads = th * tw / pix;
#define LAUNCH(PIX)                                                          \
  resolve_tiles_kernel<PIX><<<grid, threads, 0, s>>>(                        \
      (const float*)rows, (const int32_t*)faces, (const int32_t*)floor_keys, \
      (const int32_t*)counts, g0, (const int32_t*)n_global, m, th, tw, ntx,  \
      (int32_t*)out)
  if (pix == 4) LAUNCH(4);
  else if (pix == 2) LAUNCH(2);
  else LAUNCH(1);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// Per-tile z-buffer resolve of the rasterizer, exact: every face of a
// tile's list competes, however long the list.
//
// Replaces the Pallas TPU kernel d3human_tpu/ops/pallas_raster.py:64
// _resolve_body (via _resolve_kernel / _resolve_kernel_peel, called from
// resolve_tiles_pallas at :151), whose tile held at most 1,024 slots: its
// key (zq << 10) | slot had 10 bits for the slot, so the binning cut each
// list to its nearest 896 faces and the shared list of oversize faces to
// its nearest 128. At the reference's sizes (1080^2, a 128^3 lattice) lists
// reach 2,100-4,500 faces, and the cut dropped visible faces.
//
// For every tile of th x tw pixels, each pixel centre is tested against the
// fused 16-float face rows [A0x A0y A1x A1y A2x A2y | C0 C1 C2 | az bz cz |
// live | pad3] of the tile's list; the pixel keeps the integer min of the
// 64-bit key (zq << 32) | pos, zq the 21-bit quantized depth and pos the
// slot's position in the binning's flat list of face ids: the tile's own
// faces, near to far, at [starts[t], starts[t+1]), then the oversize faces
// every tile shares at [big_base, big_base + *n_big). Positions grow along
// a tile's list as the Pallas kernel's slots do, so the order of the keys,
// and with it every winner, is the Pallas kernel's wherever its slots held
// the list. With a floor (one depth-peel step) only keys strictly above the
// floor compete.
//
// Bound on the card: operations (18 f32 operations per (slot, tile) pair and
// pixel, 19 with a floor, against 64 B of face row shared by a whole tile).
// The design:
//
//  * Lists, no slot matrix. A CTA reads its tile's range of the flat list
//    directly and stages each slot's row from the face table
//    rows[faces[pos]] ([F+1, 16]); nothing is laid out per slot, so a list
//    has no length limit. A row's live flag is still tested (it is uniform
//    over the CTA; a dead row costs no arithmetic).
//  * Chunks over a fixed grid. A tile's list is cut into chunks of CHUNK =
//    128 slots (its own list's, then the shared list's); NY CTAs per tile
//    take the chunks y, y + NY, y + 2 NY, ... Nothing about the lengths is
//    read back on the host: a CTA with no chunk leaves at once, and the
//    longest list (~36 chunks at the f3c sizes) is spread over NY CTAs.
//    The CTAs of a tile combine with a 64-bit integer atomicMin on the key
//    into an output filled with MISS_KEY. A minimum of integers does not
//    depend on order, so the keys stay exact and repeatable.
//  * Vector staging, overlapped. A chunk's rows are staged with 16-byte
//    cp.async copies (a row is four) into one of two shared buffers
//    (16 KB): the CTA's next chunk arrives while this one is evaluated.
//  * PIX pixels of one column per thread (4, or 2 or 1 where 4 does not
//    divide th): a row is read from shared memory once (four 16-byte
//    broadcasts) for PIX pixels, and the px products of the edge and depth
//    functions are shared by them. The depth and the key are formed only in
//    a warp of which some pixel lies inside the face (one vote); most faces
//    cover none of a warp's 32 x PIX pixels.
//  * A tile on a peel step with every pixel's floor at MISS_KEY leaves at
//    once (no later layer can hit behind a miss).
//  * The work done is counted on the device: each CTA adds the slots it
//    walked to *pairs (one atomicAdd a CTA), which the host reads only when
//    it asks (the resolve's roofline share).
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

#define ROW_W 16
#define CHUNK 128              // slots staged and walked at once
#define NY 8                   // CTAs per tile
#define MISS_KEY 0x7fffffffffffffffULL

typedef unsigned long long u64;

__global__ void fill_keys_kernel(u64* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = MISS_KEY;
}

template <int PIX>
__global__ void resolve_tiles_kernel(const float* __restrict__ rows,
                                     const int32_t* __restrict__ faces,
                                     const int32_t* __restrict__ starts,
                                     int big_base,
                                     const int32_t* __restrict__ n_big,
                                     const u64* __restrict__ floor_keys,
                                     int th, int tw, int ntx,
                                     u64* __restrict__ out,
                                     u64* __restrict__ pairs) {
  __shared__ __align__(16) float srows[2][CHUNK * ROW_W];
  const int t = blockIdx.x;
  const int P = th * tw;
  const int col = threadIdx.x % tw;
  const int row0 = (threadIdx.x / tw) * PIX;
  u64* o = out + (size_t)t * P + (size_t)row0 * tw + col;

  // the tile's chunks: its own list's, then the shared list's; this CTA
  // takes every NY-th from its own index on
  const int own0 = starts[t];
  const int own_n = starts[t + 1] - own0;
  const int big_n = *n_big;
  const int na = (own_n + CHUNK - 1) / CHUNK;
  const int nc = na + (big_n + CHUNK - 1) / CHUNK;
  const int first = blockIdx.y;
  if (first >= nc) return;               // uniform over the CTA
  const int mine = (nc - first + gridDim.y - 1) / gridDim.y;

  u64 floor_key[PIX], best[PIX];
  if (floor_keys != nullptr) {           // every floor at MISS_KEY: leave
    bool dead = true;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      floor_key[k] = floor_keys[(size_t)t * P + (size_t)(row0 + k) * tw + col];
      dead = dead && floor_key[k] == MISS_KEY;
    }
    if (__syncthreads_and(dead)) return;
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

  auto chunk_start = [&](int i) {
    const int c = first + i * (int)gridDim.y;
    return c < na ? own0 + c * CHUNK : big_base + (c - na) * CHUNK;
  };
  auto chunk_len = [&](int i) {
    const int c = first + i * (int)gridDim.y;
    return c < na ? min(CHUNK, own_n - c * CHUNK)
                  : min(CHUNK, big_n - (c - na) * CHUNK);
  };
  auto stage = [&](int i) {
    const int start = chunk_start(i), len = chunk_len(i);
    float* dst = srows[i & 1];
    for (int j = threadIdx.x; j < len * 4; j += blockDim.x) {
      const float* src = rows + (size_t)faces[start + (j >> 2)] * ROW_W;
      __pipeline_memcpy_async(dst + j * 4, src + (j & 3) * 4, 16);
    }
    __pipeline_commit();
  };

  u64 walked = 0;
  stage(0);
  for (int i = 0; i < mine; ++i) {
    if (i + 1 < mine) {
      stage(i + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int start = chunk_start(i), len = chunk_len(i);
    walked += (u64)len;
    const float4* r4 = (const float4*)srows[i & 1];
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
      const u64 pos = (u64)(unsigned)(start + j);
#pragma unroll
      for (int k2 = 0; k2 < PIX; ++k2) {
        const float z = __fadd_rn(__fmaf_rn(py[k2], rc.z, mz), rc.w);
        float zf = __fmul_rn(__fadd_rn(z, 1.0f), z_half);
        zf = fminf(fmaxf(zf, 0.0f), z_scale);
        u64 key = ((u64)(unsigned)(int)zf << 32) | pos;
        if (!hit[k2]) key = MISS_KEY;
        if (floor_keys && !(key > floor_key[k2])) key = MISS_KEY;
        best[k2] = key < best[k2] ? key : best[k2];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    if (best[k] != MISS_KEY) atomicMin(o + k * tw, best[k]);
  }
  if (threadIdx.x == 0) atomicAdd(pairs, walked);
}

// rows: the face table [F+1, 16]; faces: the flat list of face ids (int32);
// starts [nt+1]: each tile's own list; the shared list at big_base of
// *n_big faces; floor_keys [nt, th*tw] or null; out [nt, th*tw] int64;
// pairs: the u64 counter the walked (slot, tile) pairs are added to.
extern "C" int d3h_resolve_tiles(const void* rows, const void* faces,
                                 const void* starts, int big_base,
                                 const void* n_big, const void* floor_keys,
                                 int nt, int th, int tw, int ntx, void* out,
                                 void* pairs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)nt * th * tw;
  fill_keys_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>((u64*)out, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nt, NY);
  const int pix = th % 4 == 0 ? 4 : th % 2 == 0 ? 2 : 1;
  const int threads = th * tw / pix;
#define LAUNCH(PIX)                                                          \
  resolve_tiles_kernel<PIX><<<grid, threads, 0, s>>>(                        \
      (const float*)rows, (const int32_t*)faces, (const int32_t*)starts,     \
      big_base, (const int32_t*)n_big, (const u64*)floor_keys, th, tw, ntx,  \
      (u64*)out, (u64*)pairs)
  if (pix == 4) LAUNCH(4);
  else if (pix == 2) LAUNCH(2);
  else LAUNCH(1);
#undef LAUNCH
  return (int)cudaGetLastError();
}

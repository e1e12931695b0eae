// Sorted-COO scatter-add: out = zeros((out_rows, C)).at[idx].add(vals), with
// rows whose idx lies outside [0, out_rows) dropped.
//
// Replaces the Pallas TPU kernel d3human_tpu/ops/scatter.py:41
// _scatter_kernel (called from coo_scatter_add at :117). There each
// 512-row output block streams its contiguous range of destination-sorted
// rows through VMEM and accumulates with one-hot f32 MXU matmuls. Here the
// rows are sorted by destination outside the sum kernel too (where the JAX
// path calls jnp.argsort outside the Pallas call), and the sum over runs of
// equal keys is a segmented sum written by hand.
//
// Bound on the card: bytes (idx 4 B + vals 4C B per input row, 4C B per
// output row); the adds are free beside them. What held the first kernel of
// this file at 13x that bound was everything around the adds: three
// elementwise passes and a 32-bit radix sort with an 8-byte permutation in
// front, five launches of a level kernel whose threads re-read keys and
// permutation once per column, 4-byte value loads, and a read of each
// zeroed output row before it was written. This design:
//
//  * scatter_keys_kernel writes, in one pass, the int32 sort key (idx, or
//    the sentinel out_rows for an index out of range) and an int32 iota.
//    Destinations that come sorted need neither: the tile kernel maps them
//    as it stages them.
//  * The sort is cub::DeviceRadixSort::SortPairs (stable) over the key
//    bits that can be set, bit_length(out_rows), with the int32 iota as
//    the value. It is the one library call, as the argsort is in the
//    JAX package. (torch.sort on the same keys, with its int64 permutation
//    cast down, measured 1.5 to 1.9 times the time.)
//  * segsum_tile_kernel: one CTA of 256 threads per tile of TILE = 1,024
//    sorted rows (and per 16 columns, so C <= 16 is one CTA). Keys and
//    permutation of the tile go to shared memory once, coalesced. A thread
//    owns one 4-column piece of R consecutive rows (2,048-row tiles
//    measured no faster), gathers them with 16-byte loads
//    (scalar loads when C is not a multiple of 4: the rows are then not
//    16-byte aligned) and adds them in order. A run of equal keys that
//    begins and ends inside the piece is STORED to out: no read of the
//    zeroed row. The piece of a run that enters from the piece before and
//    the piece that leaves into the next become two entries (key, partial
//    sum) of a list in shared memory; an entry that is not needed carries
//    the key NONE, which no output row has. The list is reduced the same
//    way in chunks of 16 entries, level by level inside the CTA, until two
//    entries are left: the tile's carries.
//  * segsum_carry_kernel: one CTA reduces the 2 * tiles carries with the
//    same code and stores the rows they complete. A run that crosses a tile
//    edge is made of carries only, so no row is written twice and the
//    second launch needs no add either.
//
// The work is split by INPUT rows, so one destination that takes most of
// the rows (the padded slots of a compacted gather all point at one
// vertex) costs no more than any other. The order of every sum depends
// only on N, C, TILE and the keys: no float atomics, two runs give the same
// bits, and coo_scatter_add_plain in ops/scatter.py repeats the order.
//
// Not used here, and why: TMA copies dense tiles, and the value rows are
// gathered through a permutation; a one-hot product on the tensor cores
// (the TPU kernel's way) would need exact f32 products, which TF32 (10
// mantissa bits) does not give.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

#define THREADS 256
#define TILE 1024              // sorted rows per CTA of the tile kernel
#define COLS 16                // columns per CTA (blockIdx.y picks the 16)
#define CHUNK 16               // entries per thread in the shared levels
#define NONE 0x7fffffff        // key of an entry that carries nothing

__global__ void scatter_keys_kernel(const void* __restrict__ idx, int idx64,
                                    long long n, int out_rows,
                                    int32_t* __restrict__ keys,
                                    int32_t* __restrict__ iota) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = idx64 ? ((const int64_t*)idx)[i]
                            : (long long)((const int32_t*)idx)[i];
  keys[i] = (v >= 0 && v < out_rows) ? (int32_t)v : out_rows;
  if (iota != nullptr) iota[i] = (int32_t)i;
}

static cudaError_t launch_keys(const void* idx, int idx64, long long n,
                               int out_rows, int32_t* keys, int32_t* iota,
                               cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + THREADS - 1) / THREADS;
  scatter_keys_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      idx, idx64, n, out_rows, keys, iota);
  return cudaGetLastError();
}

// The bytes of scratch the sort of n pairs over end_bit key bits wants (a
// host-side query: nothing is launched).
extern "C" int d3h_sort_scratch_bytes(long long n, int end_bit,
                                      unsigned long long* bytes) {
  size_t size = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, size, (const int32_t*)nullptr, (int32_t*)nullptr,
      (const int32_t*)nullptr, (int32_t*)nullptr, (int)n, 0, end_bit);
  *bytes = (unsigned long long)size;
  return (int)err;
}

// Pieces of R rows per CTA for a CTA that holds nq 4-column pieces a row.
__host__ __device__ inline int groups_of(int nq) { return THREADS / nq; }

// One block of `len` sorted rows starting at row `row0` of `n`: `key`
// points at the block's first key and may be read at [-1] and [len] where
// those rows exist. Stores every run that lies inside the block; what
// enters or leaves goes to next_key / next_vals at entries 2 * block and
// 2 * block + 1 (the last launch has no next list: its block is the whole
// list, and nothing enters or leaves).
__device__ void segsum_block(const int32_t* key, const int32_t* perm,
                             const float* __restrict__ vals, long long n,
                             long long row0, int len, int r, int c, int col0,
                             int out_rows, float* __restrict__ out,
                             int32_t* __restrict__ next_key,
                             float* __restrict__ next_vals,
                             long long block) {
  __shared__ int32_t ekey[2][2 * THREADS];
  __shared__ __align__(16) float eval[2][2 * THREADS * 4];
  const int cw_live = min(c - col0, COLS);       // columns of this CTA
  const int nq = (cw_live + 3) / 4;
  const int cw = 4 * nq;                         // padded to whole pieces
  const int groups = groups_of(nq);
  const bool block_in = row0 > 0 && key[-1] == key[0];
  const bool block_out = row0 + len < n && key[len] == key[len - 1];
  const bool vec = (c & 3) == 0;

  // ---- level 0: R rows a thread, from device memory
  const int g = threadIdx.x / nq, q = threadIdx.x % nq;
  if (g < groups) {
    const int start = g * r;
    const int end = min(start + r, len);
    const int cq = col0 + 4 * q;                 // first column of the piece
    float head[4] = {0.f, 0.f, 0.f, 0.f}, tail[4] = {0.f, 0.f, 0.f, 0.f};
    int head_key = NONE, tail_key = NONE;
    if (start < end) {
      const bool cont_in = start > 0 ? key[start - 1] == key[start] : block_in;
      const bool cont_out = end < len ? key[end] == key[end - 1] : block_out;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int run_key = key[start];
      bool first = true;
      auto finish = [&](int k) {
        if (k >= out_rows) return;
        float* o = out + (long long)k * c + cq;
        if (vec) {
          *(float4*)o = make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (cq + j < c) o[j] = acc[j];
        }
      };
      for (int i = start; i < end; ++i) {
        const int k = key[i];
        if (k != run_key) {
          if (first && cont_in) {
#pragma unroll
            for (int j = 0; j < 4; ++j) head[j] = acc[j];
          } else {
            finish(run_key);
          }
          first = false;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = 0.f;
          run_key = k;
        }
        const long long src = perm ? (long long)perm[i] : row0 + i;
        const float* v = vals + src * c + cq;
        if (vec) {
          const float4 x = *(const float4*)v;
          acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (cq + j < c) acc[j] += v[j];
        }
      }
      if (cont_out) {
#pragma unroll
        for (int j = 0; j < 4; ++j) tail[j] = acc[j];
      } else if (first && cont_in) {
#pragma unroll
        for (int j = 0; j < 4; ++j) head[j] = acc[j];
      } else {
        finish(run_key);
      }
      if (cont_in) head_key = key[start];
      if (cont_out) tail_key = key[end - 1];
    }
    if (q == 0) {
      ekey[0][2 * g] = head_key;
      ekey[0][2 * g + 1] = tail_key;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      eval[0][(2 * g) * cw + 4 * q + j] = head[j];
      eval[0][(2 * g + 1) * cw + 4 * q + j] = tail[j];
    }
  }

  // ---- further levels: chunks of CHUNK entries, in shared memory
  int e = 2 * groups;
  int cur = 0;
  for (;;) {
    __syncthreads();
    const int chunks = (e + CHUNK - 1) / CHUNK;
    const bool last = chunks == 1;
    const int32_t* k_in = ekey[cur];
    const float* v_in = eval[cur];
    for (int w = threadIdx.x; w < chunks * cw; w += THREADS) {
      const int ch = w / cw, col = w % cw;
      const int start = ch * CHUNK;
      const int end = min(start + CHUNK, e);
      const bool cont_in = start > 0 ? k_in[start - 1] == k_in[start]
                                     : block_in;
      const bool cont_out = end < e ? k_in[end] == k_in[end - 1] : block_out;
      const bool live = col0 + col < c;
      float head = 0.f, tail = 0.f, acc = 0.f;
      int run_key = k_in[start];
      bool first = true;
      for (int i = start; i < end; ++i) {
        const int k = k_in[i];
        if (k != run_key) {
          if (first && cont_in) head = acc;
          else if (run_key < out_rows && live)
            out[(long long)run_key * c + col0 + col] = acc;
          first = false;
          acc = 0.f;
          run_key = k;
        }
        acc += v_in[i * cw + col];
      }
      if (cont_out) tail = acc;
      else if (first && cont_in) head = acc;
      else if (run_key < out_rows && live)
        out[(long long)run_key * c + col0 + col] = acc;
      const int hk = cont_in ? k_in[start] : NONE;
      const int tk = cont_out ? k_in[end - 1] : NONE;
      if (!last) {
        if (col == 0) {
          ekey[cur ^ 1][2 * ch] = hk;
          ekey[cur ^ 1][2 * ch + 1] = tk;
        }
        eval[cur ^ 1][(2 * ch) * cw + col] = head;
        eval[cur ^ 1][(2 * ch + 1) * cw + col] = tail;
      } else if (next_key != nullptr) {
        if (col == 0 && col0 == 0) {
          next_key[2 * block] = hk;
          next_key[2 * block + 1] = tk;
        }
        if (live) {
          next_vals[(2 * block) * c + col0 + col] = head;
          next_vals[(2 * block + 1) * c + col0 + col] = tail;
        }
      }
    }
    if (last) return;
    e = 2 * chunks;
    cur ^= 1;
  }
}

// mode KEYS: key holds int32 sort keys; IDX32 / IDX64: the caller's sorted
// destinations, mapped to keys here (out of range -> out_rows).
enum { KEYS = 0, IDX32 = 1, IDX64 = 2 };

__global__ void __launch_bounds__(THREADS)
segsum_tile_kernel(const void* __restrict__ key, int mode,
                   const int32_t* __restrict__ perm,
                   const float* __restrict__ vals, long long n, int c,
                   int out_rows, float* __restrict__ out,
                   int32_t* __restrict__ next_key,
                   float* __restrict__ next_vals) {
  __shared__ int32_t skey[TILE + 2];
  __shared__ int32_t sperm[TILE];
  const long long row0 = (long long)blockIdx.x * TILE;
  const int len = (int)min((long long)TILE, n - row0);
  for (int i = threadIdx.x; i < len + 2; i += THREADS) {
    const long long row = row0 + i - 1;
    if (row < 0 || row >= n) continue;
    if (mode == KEYS) {
      skey[i] = ((const int32_t*)key)[row];
    } else {
      const long long v = mode == IDX64 ? ((const int64_t*)key)[row]
                                        : (long long)((const int32_t*)key)[row];
      skey[i] = (v >= 0 && v < out_rows) ? (int32_t)v : out_rows;
    }
  }
  if (perm != nullptr)
    for (int i = threadIdx.x; i < len; i += THREADS) sperm[i] = perm[row0 + i];
  __syncthreads();
  const int col0 = blockIdx.y * COLS;
  const int nq = (min(c - col0, COLS) + 3) / 4;
  const int groups = groups_of(nq);
  segsum_block(skey + 1, perm ? sperm : nullptr, vals, n, row0, len,
               (TILE + groups - 1) / groups, c, col0, out_rows, out, next_key,
               next_vals, blockIdx.x);
}

__global__ void __launch_bounds__(THREADS)
segsum_carry_kernel(const int32_t* __restrict__ key,
                    const float* __restrict__ vals, int n, int c,
                    int out_rows, float* __restrict__ out) {
  const int col0 = blockIdx.y * COLS;
  const int nq = (min(c - col0, COLS) + 3) / 4;
  const int groups = groups_of(nq);
  segsum_block(key, nullptr, vals, n, 0, n, (n + groups - 1) / groups, c,
               col0, out_rows, out, nullptr, nullptr, 0);
}

// key / mode: n sorted keys or destinations (see segsum_tile_kernel); perm:
// the sort's int32 permutation, or null when vals are already in key order.
// carry_key / carry_vals: 2 * tiles entries of scratch (tiles =
// ceil(n / TILE)), unused when n <= TILE. Launches: 1 when n <= TILE, else 2.
static cudaError_t launch_sum(const void* key, int mode, const int32_t* perm,
                              const float* vals, long long n, int c,
                              int out_rows, float* out, int32_t* carry_key,
                              float* carry_vals, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(out, 0,
                                    (size_t)out_rows * c * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return err;
  const long long tiles = (n + TILE - 1) / TILE;
  const unsigned ny = (unsigned)((c + COLS - 1) / COLS);
  const bool one = tiles == 1;
  segsum_tile_kernel<<<dim3((unsigned)tiles, ny), THREADS, 0, s>>>(
      key, mode, perm, vals, n, c, out_rows, out,
      one ? nullptr : carry_key, one ? nullptr : carry_vals);
  err = cudaGetLastError();
  if (err != cudaSuccess || one) return err;
  segsum_carry_kernel<<<dim3(1, ny), THREADS, 0, s>>>(
      carry_key, carry_vals, (int)(2 * tiles), c, out_rows, out);
  return cudaGetLastError();
}

static long long up4(long long x) { return (x + 3) & ~3LL; }

// The whole scatter in one call: keys + iota, sort, the two sum kernels
// (sorted != 0: the sum kernels alone, reading idx). work: temp_bytes
// (rounded up to 256) bytes of sort scratch, then int32 words: unless
// sorted 4 * up4(n) for keys, iota, sorted keys and permutation; then
// up4(2 * tiles) carry keys and 2 * tiles * c carry values.
extern "C" int d3h_coo_scatter_add(const void* idx, int idx64,
                                   const void* vals, long long n, int c,
                                   int out_rows, int sorted, int end_bit,
                                   void* work, unsigned long long temp_bytes,
                                   void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + TILE - 1) / TILE;
  int32_t* w = (int32_t*)((char*)work + ((temp_bytes + 255) & ~255ULL));
  const void* key = idx;
  int mode = idx64 ? IDX64 : IDX32;
  const int32_t* perm = nullptr;
  if (!sorted && n > 0) {
    int32_t* keys = w;
    int32_t* iota = keys + up4(n);
    int32_t* skeys = iota + up4(n);
    int32_t* sperm = skeys + up4(n);
    w = sperm + up4(n);
    cudaError_t err = launch_keys(idx, idx64, n, out_rows, keys, iota, s);
    if (err != cudaSuccess) return (int)err;
    size_t bytes = (size_t)temp_bytes;
    err = cub::DeviceRadixSort::SortPairs(work, bytes, keys, skeys, iota,
                                          sperm, (int)n, 0, end_bit, s);
    if (err != cudaSuccess) return (int)err;
    key = skeys;
    mode = KEYS;
    perm = sperm;
  }
  return (int)launch_sum(key, mode, perm, (const float*)vals, n, c, out_rows,
                         (float*)out, w, (float*)(w + up4(2 * tiles)), s);
}

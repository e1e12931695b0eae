// The fields MLP's activation after each hidden product, forward and
// backward, one pass over the activations each:
//   forward   h = softplus(100 (z + b)) / 100 of the product z [n, c] and
//             the bias b [c], written as the rows of out, optionally with
//             tail [n, t] (the positional encoding before a skip layer)
//             beside it: out = [h, tail] [n, c + t], the next product's
//             input, so no concatenation runs after it;
//   backward  g_z = g_h * sigmoid(100 (z + b)) of the gradient g_h of h,
//             read back from h alone: sigmoid(100 (z + b)) =
//             1 - exp(-softplus(100 (z + b))) = -expm1(-100 h); and g_b,
//             the column sums of g_z.
//
// A port-only kernel: it replaces no Pallas kernel. The JAX package's MLP
// (d3human_tpu/models/fields.py) is plain jnp, which XLA fuses into the
// products' neighbours; in PyTorch the chain + b, x100, softplus, x0.01
// after each product is four passes over the activations forward, about
// seven backward plus a separate column reduction, and softplus keeps its
// input 100 (z + b) for the backward.
//
// Bound on the card: bytes. At the SDF fit's 674,310 points x 256 the
// forward reads z and writes h, 1.38 GB (0.41 ms at 3.35 TB/s); the
// backward reads g_h and h and writes g_z, 2.07 GB (0.62 ms). expf and
// log1pf cost about 40 single-precision instructions an entry, under the
// time of its 8 bytes.
//
// The forward does PyTorch's operations in their order, in float, with the
// same accurate expf / log1pf (no fast-math intrinsics): (z + b) * 100,
// then softplus with threshold 20 (x > 20 ? x : log1p(exp(x))), then
// * 0.01; so it equals torch's F.softplus(100 * (z + b)) * 0.01 bit for bit.
//
// Design: a CTA of 32 x 8 threads takes ROWS rows of a tile of 32 * VEC
// columns; a thread takes VEC neighbouring columns of every 8th row. VEC
// is 4 (16-byte loads and stores) when every row of every operand starts
// on a 16-byte line and there is no tail, else 1 (a warp still reads 128
// contiguous bytes a row); with a tail the VEC 1 forward runs over the
// c + t columns of out, copying the tail's. The column tiles of one block
// of rows are neighbouring CTAs, so the CTAs in flight read and write
// whole stretches of memory (tiles outermost read 128-byte pieces of rows
// far apart, at two thirds of the speed). The backward adds each thread's
// column sums in double, in row order, then the 8 row lanes in lane order,
// into partial[col, row block] (the same order for VEC 4 and 1); a second
// launch adds each column's partials in a fixed order (strided by thread,
// then a tree). No atomics, so two runs give the same bits.
//
// On an H100 80GB HBM3 at 700 W, at 674,310 x 256: forward 0.49 ms,
// backward 0.72 ms (a plain copy of z takes 0.46 ms); before the skip
// layer, rows of 295, 0.89 and 0.84 ms (PyTorch's copy of z into such rows
// takes 0.62 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#define TX 32                   // threads along the columns
#define TY 8                    // row lanes of a CTA
#define ROWS 256                // rows of a CTA
#define RTHREADS 256            // threads of the reduce CTA

template <int VEC>
__device__ __forceinline__ void load(const float* __restrict__ p, float* v) {
  if (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ p, const float* v) {
  if (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}

// PyTorch's x * 100, softplus (beta 1, threshold 20), * 0.01, in float
__device__ __forceinline__ float softplus100(float x) {
  const float u = x * 100.0f;
  const float s = u > 20.0f ? u : log1pf(expf(u));
  return s * 0.01f;
}

// one thread's rows of the forward: VEC columns from z, or (VEC 1 past c)
// one column of the tail
template <int VEC>
__global__ void __launch_bounds__(TX * TY)
    bias_softplus_fwd_kernel(const float* __restrict__ z,
                             const float* __restrict__ b,
                             const float* __restrict__ tail, long long ldt,
                             int t, float* __restrict__ out, long long ldo,
                             long long n, int c) {
  const int w = c + t;
  const int tiles = (w + TX * VEC - 1) / (TX * VEC);
  const int col = (blockIdx.x % tiles * TX + threadIdx.x) * VEC;
  const long long r0 = (long long)(blockIdx.x / tiles) * ROWS;
  const long long r1 = r0 + ROWS < n ? r0 + ROWS : n;
  if (col >= w) return;
  if (VEC == 1 && col >= c) {
    const float* __restrict__ src = tail + (col - c);
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += TY)
      out[r * ldo + col] = src[r * ldt];
    return;
  }
  float bias[VEC];
  load<VEC>(b + col, bias);
#pragma unroll 4
  for (long long r = r0 + threadIdx.y; r < r1; r += TY) {
    float v[VEC];
    load<VEC>(z + r * c + col, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = softplus100(v[j] + bias[j]);
    store<VEC>(out + r * ldo + col, v);
  }
}

template <int VEC>
__global__ void __launch_bounds__(TX * TY)
    bias_softplus_bwd_kernel(const float* __restrict__ g, long long ldg,
                             const float* __restrict__ h, long long ldh,
                             float* __restrict__ gz, long long n, int c,
                             double* __restrict__ partial) {
  __shared__ double lanes[TY][TX * VEC];
  const int tiles = (c + TX * VEC - 1) / (TX * VEC);
  const int col = (blockIdx.x % tiles * TX + threadIdx.x) * VEC;
  const unsigned rb = blockIdx.x / tiles;
  const long long r0 = (long long)rb * ROWS;
  const long long r1 = r0 + ROWS < n ? r0 + ROWS : n;
  double acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
  if (col < c) {
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += TY) {
      float gv[VEC], hv[VEC];
      load<VEC>(g + r * ldg + col, gv);
      load<VEC>(h + r * ldh + col, hv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        gv[j] = gv[j] * -expm1f(-100.0f * hv[j]);
        acc[j] += (double)gv[j];
      }
      store<VEC>(gz + r * c + col, gv);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    lanes[threadIdx.y][threadIdx.x * VEC + j] = acc[j];
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      double s = lanes[0][threadIdx.x * VEC + j];
#pragma unroll
      for (int y = 1; y < TY; ++y) s += lanes[y][threadIdx.x * VEC + j];
      partial[(long long)(col + j) * (gridDim.x / tiles) + rb] = s;
    }
  }
}

// g_b[col] = the sum of partial[col, 0..nb) (one CTA a column)
__global__ void __launch_bounds__(RTHREADS)
    bias_grad_reduce_kernel(const double* __restrict__ partial, int nb,
                            float* __restrict__ gb) {
  __shared__ double sh[RTHREADS];
  const double* p = partial + (long long)blockIdx.x * nb;
  double acc = 0.0;
  for (int i = threadIdx.x; i < nb; i += RTHREADS) acc += p[i];
  sh[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int s = RTHREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) gb[blockIdx.x] = (float)sh[0];
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// one CTA a block of ROWS rows and a tile of TX * vec columns, the tiles
// of a block of rows neighbours
static unsigned grid_of(long long n, int c, int vec) {
  return (unsigned)((n + ROWS - 1) / ROWS) *
         (unsigned)((c + TX * vec - 1) / (TX * vec));
}

// z: float32 [n, c] contiguous; b: [c]; tail: [n, t] with row stride ldt
// (unread when t is 0); out: [n, ldo] with ldo >= c + t. 0 < n, 0 < c,
// ceil(n / ROWS) * ceil(c / TX) < 2^31. Returns the launch's error, else 0.
extern "C" int d3h_bias_softplus100(const void* z, const void* b,
                                    const void* tail, long long ldt, int t,
                                    void* out, long long ldo, long long n,
                                    int c, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(TX, TY);
  const bool vec = t == 0 && c % 4 == 0 && ldo % 4 == 0 && aligned16(z) &&
                   aligned16(b) && aligned16(out);
  if (vec)
    bias_softplus_fwd_kernel<4><<<grid_of(n, c, 4), block, 0, s>>>(
        (const float*)z, (const float*)b, (const float*)tail, ldt, t,
        (float*)out, ldo, n, c);
  else
    bias_softplus_fwd_kernel<1><<<grid_of(n, c + t, 1), block, 0, s>>>(
        (const float*)z, (const float*)b, (const float*)tail, ldt, t,
        (float*)out, ldo, n, c);
  return (int)cudaGetLastError();
}

// g: float32 [n, c] with row stride ldg; h: [n, c] with row stride ldh;
// gz: [n, c] contiguous; partial: double scratch [c, ceil(n / ROWS)]; gb:
// [c]. Two launches: g_z and the partials, then g_b. Returns the first
// launch error, else 0.
extern "C" int d3h_bias_softplus100_backward(const void* g, long long ldg,
                                             const void* h, long long ldh,
                                             void* gz, void* partial,
                                             void* gb, long long n, int c,
                                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(TX, TY);
  const bool vec = c % 4 == 0 && ldg % 4 == 0 && ldh % 4 == 0 &&
                   aligned16(g) && aligned16(h) && aligned16(gz);
  if (vec)
    bias_softplus_bwd_kernel<4><<<grid_of(n, c, 4), block, 0, s>>>(
        (const float*)g, ldg, (const float*)h, ldh, (float*)gz, n, c,
        (double*)partial);
  else
    bias_softplus_bwd_kernel<1><<<grid_of(n, c, 1), block, 0, s>>>(
        (const float*)g, ldg, (const float*)h, ldh, (float*)gz, n, c,
        (double*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bias_grad_reduce_kernel<<<(unsigned)c, RTHREADS, 0, s>>>(
      (const double*)partial, (int)((n + ROWS - 1) / ROWS), (float*)gb);
  return (int)cudaGetLastError();
}

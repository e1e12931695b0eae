// The fields MLP's input and hidden layers: the product with the weights
// and the bias + Softplus(beta=100) in one f32 GEMM, forward and input
// gradient, so neither the product nor the gradient of a layer's output
// makes a round trip through device memory:
//   forward  out = [softplus(100 (x @ w + b)) / 100, tail] of the layer's
//            input x [m, k], its weights w [k, nc] and bias b [nc], the
//            softplus taken on the accumulators; tail [m, t] (the
//            positional encoding before a skip layer) is copied beside it,
//            so out is the next product's input. out's row stride is a
//            multiple of 4 floats (296 for rows of 295), so every row starts
//            on 16 bytes;
//   dx       g_z' = (g_z @ w^T)[:, :nout] * -expm1(-100 h) of the gradient
//            g_z [m, kd] of a layer's pre-activation, its weights' rows
//            [0, nout) transposed, wt [kd, nout] (the positional encoding's
//            rows of a skip layer get no gradient), and the layer's input h
//            [m, >= nout], the lower layer's output: sigmoid(100 z') =
//            1 - exp(-softplus(100 z')) = -expm1(-100 h). So g_z' is the
//            lower layer's pre-activation gradient, and its column sums,
//            the lower layer's bias gradient, leave each CTA as partial sums
//            in double; a second launch adds them in a fixed order.
// The weight gradients h^T @ g_z stay plain products (torch.matmul).
//
// A port-only kernel: it replaces no Pallas kernel. The JAX package's MLP
// (d3human_tpu/models/fields.py) is plain jnp, which XLA fuses; in the port
// the products were cuBLAS GEMMs and the bias + softplus a pass of its own
// (csrc/softplus100.cu), which read back each product and each incoming
// gradient: at the SDF fit's 674,310 points, 1.38 GB a layer and direction.
//
// Bound on the card: f32 operations. A layer's forward is 2 m k nc FFMA
// operations (m = 674,310, k = 256, nc = 256: 88.4 GFLOP, 1.32 ms at the
// 67 TFLOP/s f32 rate) against 1.38 GB of bytes (0.41 ms); the dx the same
// at kd = 256. The epilogues' expf / log1pf and expm1f take about 45 and
// 30 issue slots an entry, some 17 % and 12 % beside the 256 FFMAs of an
// entry at k = 256: the price of the exact functions (MUFU-based ones
// issue as many slots).
//
// Arithmetic: f32 FFMA with f32 accumulation, each entry's sum in k order
// (no TF32, no split-k): at the fit's shapes the bits of cuBLAS's f32 SIMT
// GEMMs, and two runs give the same bits. The epilogues repeat csrc/softplus100.cu's
// float operations: (z + b) * 100, softplus with threshold 20, * 0.01;
// g * -expm1f(-100 h); no fast-math intrinsics.
//
// Design: a CTA of 128 threads computes a 128 x 128 tile of the output
// over BK = 8 deep stages of a 5-stage cp.async pipeline (4 stages of
// copies in flight while one is multiplied; 2 CTAs a multiprocessor, at
// about 250 registers a thread). A, stored with k contiguous (x, g_z), is
// copied 4 bytes at a time and transposed on the way, so the shared tile
// holds rows of m; B [k, 128] (w, or w's rows transposed for dx) is copied
// 16 bytes at a time as it lies. A thread holds 16 x 8 of the tile (4
// warps, 2 x 2, each 64 x 64; lanes 4 x 8): each k step reads 4 A float4s
// (a quarter warp reads one, broadcast) and 2 B float4s (128 neighbouring
// bytes a quarter warp) for 128 FFMAs, as cuBLAS's 256 x 128 SIMT tile
// does. The column tiles of a block of rows are neighbouring CTAs, so x's
// rows come from device memory once and from L2 for the second tile. The
// epilogues compute every entry first, without a branch (a branch per
// entry serialised them: 0.5 ms of 2.44 at k = 256), then store float4s (a
// quarter warp writes 128 contiguous bytes of a row). dx's column sums:
// each thread adds its 16 rows in double, the CTA's 8 row groups are
// added in order through shared memory, one double per column and CTA.
//
// On an H100 80GB HBM3 at 700 W: see PERF.md's kernel table (chip_smoke.py
// kernels phase, kernel_linear_softplus).

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 128                  // rows of a CTA's tile
#define BN 128                  // columns of a CTA's tile
#define BK 8                    // depth of a pipeline stage
#define STAGES 5                // stages of the cp.async pipeline
#define THREADS 128             // 4 warps, 2 x 2, each 64 x 64
#define MIN_CTAS 2              // CTAs a multiprocessor holds at once
#define ALD (BM + 4)            // A's shared row: BK rows of BM floats
#define A_COPIES (BM * BK / THREADS)        // 4-byte A copies a thread
#define A_ROWS (THREADS / BK)               // rows of a pass of A copies
#define B_COPIES (BK * BN / 4 / THREADS)    // 16-byte B copies a thread
#define RGROUPS 8               // threads that hold one column (dx's sums)
#define RTHREADS 256            // threads of the reduce CTA

static_assert(STAGES * (BK * ALD + BK * BN) * 4 <= 48 * 1024,
              "static shared memory");

// PyTorch's x * 100, softplus (beta 1, threshold 20), * 0.01, in float,
// without a branch: log1p(exp(.)) is taken of min(u, 20) (NaN stays NaN)
// and the threshold selects, so the compiler interleaves the epilogue's
// 128 entries a thread instead of running one branch after another
__device__ __forceinline__ float softplus100(float x) {
  const float u = x * 100.0f;
  const float l = log1pf(expf(u > 20.0f ? 20.0f : u));
  return (u > 20.0f ? u : l) * 0.01f;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// an asynchronous copy of 16 (4) bytes to shared memory, of which the
// first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's part of the tile: 16 rows (ar + 16 q + 0..3, q < 4) by 8
// columns (bc + 32 g + 0..3, g < 2); a warp's lanes are 4 (rows) by 8
// (columns), so a quarter warp reads one A float4 (broadcast) and 8
// neighbouring B float4s (128 bytes)
struct Frag {
  int ar, bc;
};

__device__ __forceinline__ Frag frag_of() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return Frag{(warp >> 1) * 64 + (lane >> 3) * 4,
              (warp & 1) * 64 + (lane & 7) * 4};
}

// row of acc[i] in the tile
__device__ __forceinline__ int row_of(const Frag& f, int i) {
  return f.ar + (i & 3) + 16 * (i >> 2);
}

// acc[i][j] += a[i] b[j] over a stage's k, in k order, from A's stage
// [BK][ALD] (m contiguous) and B's [BK][BN]
__device__ __forceinline__ void multiply(const float* __restrict__ as,
                                         const float* __restrict__ bs,
                                         const Frag& f, float (*acc)[8]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[16], b[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(
          as + kk * ALD + f.ar + 16 * q);
      a[4 * q] = t.x;
      a[4 * q + 1] = t.y;
      a[4 * q + 2] = t.z;
      a[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(
          bs + kk * BN + f.bc + 32 * g);
      b[4 * g] = t.x;
      b[4 * g + 1] = t.y;
      b[4 * g + 2] = t.z;
      b[4 * g + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The main loop of both kernels: acc = A[m0:m0+128, :k] @ B[:k, n0:n0+128]
// of A [m, k] (row stride lda, k contiguous) and B [k, nb] (row stride
// ldb, a multiple of 4, 16-byte aligned), STAGES - 1 stages of copies in
// flight. A is copied 4 bytes at a time and transposed on the way: a
// thread takes column k0 + tid % BK of every A_ROWS-th row, so a warp
// reads 4 rows' 32-byte pieces and writes 32 banks. Past k and past the
// last row the copies read nothing and fill zeros (a padded row's last
// float is never read).
__device__ __forceinline__ void mainloop(
    const float* __restrict__ a, long long lda, long long m,
    const float* __restrict__ b, long long ldb, int nb, int k, long long m0,
    int n0, float* as, float* bs, float (*acc)[8]) {
  const int tid = threadIdx.x;
  const int akk = tid % BK, ar0 = tid / BK;
  const long long arows = m - m0 - ar0;      // A rows left from ar0
  const float* asrc = a + (m0 + ar0) * lda + akk;
  const long long astep = (long long)A_ROWS * lda;
  const float* bsrc[B_COPIES];
  int bkr[B_COPIES], bdst[B_COPIES];
  bool bok[B_COPIES];
#pragma unroll
  for (int p = 0; p < B_COPIES; ++p) {
    const int c = tid + p * THREADS, kr = c / (BN / 4), n = (c % (BN / 4)) * 4;
    bkr[p] = kr;
    bok[p] = n0 + n < nb;
    bsrc[p] = b + (long long)kr * ldb + (bok[p] ? n0 + n : 0);
    bdst[p] = kr * BN + n;
  }
  const int nk = (k + BK - 1) / BK;
  auto issue = [&](int t) {
    float* sa = as + (t % STAGES) * (BK * ALD) + akk * ALD + ar0;
    float* sb = bs + (t % STAGES) * (BK * BN);
    const int k0 = t * BK;
    const bool kin = k0 + akk < k;
#pragma unroll
    for (int p = 0; p < A_COPIES; ++p) {
      const bool in = kin && p * A_ROWS < arows;
      copy4(sa + p * A_ROWS, in ? asrc + p * astep + k0 : a, in ? 4 : 0);
    }
#pragma unroll
    for (int p = 0; p < B_COPIES; ++p) {
      const bool in = bok[p] && k0 + bkr[p] < k;
      copy16(sb + bdst[p], in ? bsrc[p] + (long long)k0 * ldb : b,
             in ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const Frag f = frag_of();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) issue(t);
    copy_commit();
  }
  for (int t = 0; t < nk; ++t) {
    copy_wait<STAGES - 2>();   // stage t has landed (this thread's part)
    __syncthreads();           // ... every thread's; stage t - 1 is free
    if (t + STAGES - 1 < nk) issue(t + STAGES - 1);
    copy_commit();
    multiply(as + (t % STAGES) * (BK * ALD), bs + (t % STAGES) * (BK * BN),
             f, acc);
  }
  copy_wait<0>();
  __syncthreads();             // the stages may be reused
}

#define SMEM_FLOATS (STAGES * (BK * ALD + BK * BN))
static_assert(SMEM_FLOATS * 4 >= RGROUPS * BN * 8, "column sums fit");

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    linear_softplus_fwd_kernel(const float* __restrict__ x, long long ldx,
                               int k, const float* __restrict__ w,
                               const float* __restrict__ bias, int nc,
                               const float* __restrict__ tail, long long ldt,
                               int t, float* __restrict__ out, long long ldo,
                               long long m) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int ntn = (nc + BN - 1) / BN;
  const int ct = blockIdx.x % ntn;
  const long long m0 = (long long)(blockIdx.x / ntn) * BM;
  const int n0 = ct * BN;
  float acc[16][8];
  mainloop(x, ldx, m, w, nc, nc, k, m0, n0, smem,
                 smem + STAGES * BK * ALD, acc);

  const Frag f = frag_of();
  float bv[8];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c = n0 + f.bc + 32 * g;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < nc) q = __ldg(reinterpret_cast<const float4*>(bias + c));
    bv[4 * g] = q.x;
    bv[4 * g + 1] = q.y;
    bv[4 * g + 2] = q.z;
    bv[4 * g + 3] = q.w;
  }
  // all the math first, then the stores: no branch between the entries
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = softplus100(acc[i][j] + bv[j]);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const long long rr = m0 + row_of(f, i);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = n0 + f.bc + 32 * g;
      if (rr < m && c < nc)
        *reinterpret_cast<float4*>(out + rr * ldo + c) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
    }
  }
  // the tail beside h: the last column tile's CTA copies its rows' tail
  if (t > 0 && ct == ntn - 1) {
    const long long rows = m - m0 < BM ? m - m0 : BM;
    for (int e = threadIdx.x; e < rows * t; e += THREADS) {
      const long long rr = m0 + e / t;
      const int j = e % t;
      out[rr * ldo + nc + j] = __ldg(tail + rr * ldt + j);
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    linear_softplus_dx_kernel(const float* __restrict__ g, long long ldg,
                              int kd, const float* __restrict__ wt,
                              const float* __restrict__ h, long long ldh,
                              float* __restrict__ gz, long long m, int nout,
                              double* __restrict__ partial) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int ntn = (nout + BN - 1) / BN;
  const int ct = blockIdx.x % ntn;
  const unsigned rt = blockIdx.x / ntn;
  const long long m0 = (long long)rt * BM;
  const int n0 = ct * BN;
  float acc[16][8];
  mainloop(g, ldg, m, wt, nout, nout, kd, m0, n0, smem,
                 smem + STAGES * BK * ALD, acc);

  const Frag f = frag_of();
  // rows past m and columns past nout hold 0 (their copies filled zeros),
  // and their h reads as 0, so they add 0 to the column sums
  double cs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cs[j] = 0.0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const long long rr = m0 + row_of(f, i);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = n0 + f.bc + 32 * q;
      const bool in = rr < m && c < nout;
      float4 hv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) hv = __ldg(reinterpret_cast<const float4*>(h + rr * ldh + c));
      float4 v;
      v.x = acc[i][4 * q] * -expm1f(-100.0f * hv.x);
      v.y = acc[i][4 * q + 1] * -expm1f(-100.0f * hv.y);
      v.z = acc[i][4 * q + 2] * -expm1f(-100.0f * hv.z);
      v.w = acc[i][4 * q + 3] * -expm1f(-100.0f * hv.w);
      if (in) *reinterpret_cast<float4*>(gz + rr * nout + c) = v;
      cs[4 * q] += (double)v.x;
      cs[4 * q + 1] += (double)v.y;
      cs[4 * q + 2] += (double)v.z;
      cs[4 * q + 3] += (double)v.w;
    }
  }
  // the CTA's column sums, row group (warp row, lane row) by row group
  double* red = reinterpret_cast<double*>(smem);     // [RGROUPS][BN]
  const int rg = (threadIdx.x >> 6) * 4 + ((threadIdx.x & 31) >> 3);
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[rg * BN + f.bc + 32 * q + j] = cs[4 * q + j];
  __syncthreads();
  if (threadIdx.x < BN && n0 + (int)threadIdx.x < nout) {
    double s = red[threadIdx.x];
#pragma unroll
    for (int q = 1; q < RGROUPS; ++q) s += red[q * BN + threadIdx.x];
    partial[(long long)(n0 + threadIdx.x) * (gridDim.x / ntn) + rt] = s;
  }
}

// g_b[col] = the sum of partial[col, 0..nb) (one CTA a column)
__global__ void __launch_bounds__(RTHREADS)
    linear_softplus_bias_grad_kernel(const double* __restrict__ partial,
                                     int nb, float* __restrict__ gb) {
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

static unsigned grid_of(long long m, int n) {
  return (unsigned)((m + BM - 1) / BM) * (unsigned)((n + BN - 1) / BN);
}

// x: float32 [m, k] with row stride ldx; w: [k, nc] contiguous, 16-byte
// aligned; bias: [nc], 16-byte aligned; tail: [m, t] with row stride ldt
// (unread when t is 0); out: [m, ldo], 16-byte aligned, ldo >= nc + t and a
// multiple of 4. 0 < m, 0 < k, 0 < nc, nc a multiple of 4. Returns the
// launch's error, else 0.
extern "C" int d3h_linear_softplus100(const void* x, long long ldx, int k,
                                      const void* w, const void* bias,
                                      int nc, const void* tail,
                                      long long ldt, int t, void* out,
                                      long long ldo, long long m,
                                      void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  linear_softplus_fwd_kernel<<<grid_of(m, nc), THREADS, 0, s>>>(
      (const float*)x, ldx, k, (const float*)w, (const float*)bias, nc,
      (const float*)tail, ldt, t, (float*)out, ldo, m);
  return (int)cudaGetLastError();
}

// g: float32 [m, kd] with row stride ldg; wt: [kd, nout] contiguous,
// 16-byte aligned (the rows [0, nout) of the layer's weights, transposed);
// h: [m, >= nout] with row stride ldh, a multiple of 4, 16-byte aligned;
// gz: [m, nout] contiguous, 16-byte aligned; partial: double scratch
// [nout, ceil(m / 128)]; gb: [nout]. 0 < m, 0 < kd, 0 < nout, nout a
// multiple of 4. Two launches: g_z and the partial column sums, then g_b.
// Returns the first launch error, else 0.
extern "C" int d3h_linear_softplus100_dx(const void* g, long long ldg,
                                         int kd, const void* wt,
                                         const void* h, long long ldh,
                                         void* gz, long long m, int nout,
                                         void* partial, void* gb,
                                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  linear_softplus_dx_kernel<<<grid_of(m, nout), THREADS, 0, s>>>(
      (const float*)g, ldg, kd, (const float*)wt, (const float*)h, ldh,
      (float*)gz, m, nout, (double*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  linear_softplus_bias_grad_kernel<<<(unsigned)nout, RTHREADS, 0, s>>>(
      (const double*)partial, (int)((m + BM - 1) / BM), (float*)gb);
  return (int)cudaGetLastError();
}

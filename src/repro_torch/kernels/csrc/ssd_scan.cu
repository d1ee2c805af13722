// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces src/repro/kernels/ssd_scan.py:65 (ssd_scan / _ssd_kernel), the
// Pallas TPU kernel, with the same contract: x (B, S, H, P), dt (B, S, H)
// post-softplus, A (H,) negative, Bm and Cm (B, S, N), all contiguous; the
// sequence is cut into chunks of q = min(chunk, S) steps (S a multiple of
// q) and y (B, S, H, P) is float32.  Per chunk, with a = A[h]:
//   cum    = cumsum(dt * a)
//   M      = (C B^T) * L * dt_j,   L[i][j] = exp(cum_i - cum_j) if j <= i else 0
//   y      = M x + exp(cum) * (C state)
//   state' = state * exp(cum_last) + (B * (exp(cum_last - cum) * dt))^T x
// All of it in f32, as the Pallas kernel does it: bf16 inputs are widened
// to f32 (exactly) as they are staged, and every product is an f32 x f32
// FMA with f32 accumulation.  No tensor cores, so no TF32.
//
// What bounds it.  The work the scan needs, at the mamba2_130m prefill
// shape (B=4, S=4096, H=32, P=64, N=128, Q=128): C B^T on the causal pairs,
// Q (Q + 1) N flops once per (b, chunk), since all heads share one B and C
// (0.27 GFLOP of bf16 x bf16 products on the model path, exact in f32, at
// 989 TFLOP/s); and per (b, h, chunk) M x on the causal pairs, Q (Q + 1) P,
// plus C state and the state update, 4 Q N P (21.5 GFLOP of f32 FMA at
// 67 TFLOP/s).  That is 0.321 ms against 0.063 ms for the 211.8 MB that
// must move (x, dt, B, C read once, y written once in f32): the scan is
// bound by operations.
//
// What the design does about it.  This first version is simple and right:
// - One block of 256 threads per (b, h) walks its chunks in order.  The
//   loop stands in for the Pallas kernel's sequential chunk axis, and the
//   (N, P) f32 state stays in shared memory for the whole walk: it never
//   touches HBM.
// - Each chunk's x and B tiles are staged in shared memory as f32.  C and the
//   Q x Q matrix M are staged one half-chunk of 64 rows at a time, so that at
//   N=128, P=64 everything fits in 199 KB (all of it f32 would be 256 KB).
// - The products are FMA over register tiles of 4x4 (M, y) and 8x4 (state)
//   outputs per thread, read from padded shared-memory rows without bank
//   conflicts.  Column groups of M that lie wholly above the diagonal are
//   skipped.
// - Ragged chunks (q < 128: a short prompt, S <= chunk) are zero-filled in
//   shared memory past q (dt too, so they add nothing), and rows past q are
//   not stored.
// At the main shape that is 128 blocks on 132 SMs, one wave of one block
// (8 warps) per SM.  Each block forms C B^T for its own head, in f32: 8.66
// GFLOP over the 32 heads where 0.27 GFLOP would do.  Later work: split
// the chunks across blocks with a second pass over the chunk states,
// compute C B^T once per (b, chunk) instead of once per head, and use
// tensor cores where the inputs are bf16.
//
// Masked entries of M (j > i) are never formed, so a NaN in B_j does not
// reach rows i < j of its chunk; the Pallas kernel forms NaN * 0 there.
//
// C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;        // the largest chunk: rows of the x and B tiles
constexpr int kRT = 64;        // rows of one half-chunk: the C and M tiles
constexpr int kMaxN = 128;     // the largest state width
constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16 (columns), ty = tid / 16 (rows)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Shared memory in floats, for a state width padded to N16 (a multiple of 16).
__host__ __device__ constexpr int smem_floats(int N16, int P) {
  return kQ * P                // xs: x tile [kQ][P]
         + kQ * (N16 + 1)      // bs: B tile [kQ][N16 + 1]
         + kRT * (N16 + 1)     // cs: C rows of one half [kRT][N16 + 1]
         + kRT * (kQ + 1)      // ms: M rows of one half [kRT][kQ + 1]
         + N16 * P             // st: state [N16][P]
         + 2 * kQ;             // cum, dtv
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, float* __restrict__ y, int S, int H, int N,
             int q) {
  constexpr int PC = P / 16;       // columns per thread of a (., P) output
  constexpr int RN = kMaxN / 16;   // state rows per thread: n = ty + 16 r
  extern __shared__ float smem[];
  const int N16 = round16(N);
  const int LDB = N16 + 1;  // odd row lengths: column walks hit 16 distinct banks
  const int LDM = kQ + 1;
  float* xs = smem;
  float* bs = xs + kQ * P;
  float* cs = bs + kQ * LDB;
  float* ms = cs + kRT * LDB;
  float* st = ms + kRT * LDM;
  float* cum = st + N16 * P;
  float* dtv = cum + kQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];

  for (int i = tid; i < N16 * P; i += kThreads) st[i] = 0.f;

  for (int c = 0; c < S / q; ++c) {
    const size_t row0 = (size_t)b * S + (size_t)c * q;  // row (b, s) of the chunk's first step
    __syncthreads();  // the previous chunk is done with xs, bs and dtv
    for (int i = tid; i < kQ; i += kThreads) dtv[i] = i < q ? dt[(row0 + i) * H + h] : 0.f;
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i % P;
      xs[i] = r < q ? to_f32(x[((row0 + r) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < kQ * N16; i += kThreads) {
      const int r = i / N16, n = i % N16;
      bs[r * LDB + n] = (r < q && n < N) ? to_f32(Bm[(row0 + r) * N + n]) : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // cum = inclusive cumsum of dt * a: 4 steps per lane, then a warp scan
      float s[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += dtv[4 * tid + k] * a;
        s[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) cum[4 * tid + k] = excl + s[k];
    }
    __syncthreads();
    const float cum_last = cum[q - 1];

    for (int r0 = 0; r0 < q; r0 += kRT) {
      const int ncols = min(q, r0 + kRT);  // columns j of M that can be nonzero
      for (int i = tid; i < kRT * N16; i += kThreads) {
        const int r = i / N16, n = i % N16;
        cs[r * LDB + n] = (r0 + r < q && n < N) ? to_f32(Cm[(row0 + r0 + r) * N + n]) : 0.f;
      }
      __syncthreads();

      // M = (C B^T) * L * dt_j for this half's 64 rows, in groups of 64 columns.
      for (int g = 0; g * 64 < ncols; ++g) {
        float acc[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N16; ++n) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = cs[(ty * 4 + i) * LDB + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(g * 64 + tx + 16 * j) * LDB + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ig = r0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jc = g * 64 + tx + 16 * j;
            const float L = jc <= ig ? expf(cum[ig] - cum[jc]) : 0.f;
            ms[(ty * 4 + i) * LDM + jc] = acc[i][j] * L * dtv[jc];
          }
        }
      }
      __syncthreads();

      // y = M x + exp(cum) * (C state) for this half's rows.
      float yd[4][PC] = {}, yo[4][PC] = {};
#pragma unroll 4
      for (int j = 0; j < ncols; ++j) {
        float av[4], xv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ms[(ty * 4 + i) * LDM + j];
#pragma unroll
        for (int k = 0; k < PC; ++k) xv[k] = xs[j * P + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < PC; ++k) yd[i][k] = fmaf(av[i], xv[k], yd[i][k]);
      }
#pragma unroll 4
      for (int n = 0; n < N16; ++n) {
        float av[4], sv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = cs[(ty * 4 + i) * LDB + n];
#pragma unroll
        for (int k = 0; k < PC; ++k) sv[k] = st[n * P + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < PC; ++k) yo[i][k] = fmaf(av[i], sv[k], yo[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ig = r0 + ty * 4 + i;
        if (ig < q) {
          const float e = expf(cum[ig]);
          float* yrow = y + ((row0 + ig) * H + h) * P;
#pragma unroll
          for (int k = 0; k < PC; ++k) yrow[tx + 16 * k] = yd[i][k] + e * yo[i][k];
        }
      }
      __syncthreads();  // the next half refills cs and ms
    }

    // state' = state * exp(cum_last) + (B * w)^T x with w_j = exp(cum_last - cum_j) * dt_j;
    // B is scaled in place (the Pallas kernel's rounding: B * w, then the product).
    for (int i = tid; i < kQ * N16; i += kThreads) {
      const int j = i / N16, n = i % N16;
      bs[j * LDB + n] *= expf(cum_last - cum[j]) * dtv[j];
    }
    __syncthreads();
    const float decay = expf(cum_last);
    float acc[RN][PC] = {};
#pragma unroll 2
    for (int j = 0; j < q; ++j) {
      float xv[PC];
#pragma unroll
      for (int k = 0; k < PC; ++k) xv[k] = xs[j * P + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        if (16 * r < N16) {
          const float bv = bs[j * LDB + ty + 16 * r];
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(bv, xv[k], acc[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      if (16 * r < N16) {
        float* srow = st + (ty + 16 * r) * P;
#pragma unroll
        for (int k = 0; k < PC; ++k) srow[tx + 16 * k] = srow[tx + 16 * k] * decay + acc[r][k];
      }
    }
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, int B, int S, int H, int N, int q,
                   cudaStream_t stream) {
  // Raise the dynamic shared-memory limit once per instantiation, to the
  // largest N, on the first launch (which happens before any CUDA graph
  // capture that the caller starts).
  static cudaError_t configured = cudaFuncSetAttribute(
      ssd_scan_fwd<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(kMaxN, P) * sizeof(float)));
  if (configured != cudaSuccess) return configured;
  const size_t smem = smem_floats(round16(N), P) * sizeof(float);
  const dim3 grid(H, B);
  ssd_scan_fwd<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(y), S, H, N, q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, void* y, int B, int S, int H, int P, int N, int q,
                     cudaStream_t s) {
  switch (P) {
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, y, B, S, H, N, q, s);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, y, B, S, H, N, q, s);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, y, B, S, H, N, q, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of x, Bm and Cm: 0 = float32, 1 = bfloat16; dt, A and y are float32.
// Returns a cudaError_t.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* y, int dtype,
                                  int B, int S, int H, int P, int N, int q, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || q < 1 || q > kQ || S % q || N < 8 || N > kMaxN ||
      N % 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_p<float>(x, dt, A, Bm, Cm, y, B, S, H, P, N, q, s);
  if (dtype == 1) return launch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, q, s);
  return cudaErrorInvalidValue;
}

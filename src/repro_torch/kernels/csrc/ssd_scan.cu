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
// P is 16, 32, 64 or 128 (Jamba's heads), N a multiple of 8 up to 128, and
// the chunk at most 128.
//
// What bounds it.  The work the scan needs, at the mamba2_130m prefill
// shape (B=4, S=4096, H=32, P=64, N=128, Q=128): C B^T on the causal pairs,
// Q (Q + 1) N flops once per (b, chunk), since all heads share one B and C
// (0.27 GFLOP), and per (b, h, chunk) M x on the causal pairs, Q (Q + 1) P,
// plus C state and the state update, 4 Q N P (21.5 GFLOP), against the
// 211.8 MB that must move (x, dt, B, C read once, y written once in f32).
// In f32 FMA at 67 TFLOP/s the products alone take 0.32 ms against 0.063 ms
// for the bytes.  This kernel runs the per-head products on the tensor cores
// in two bf16 passes each (below), 43 GFLOP at 989 TFLOP/s, 0.044 ms: at its
// own bound it would be limited by the bytes.
//
// bf16 inputs (the model path), two kernels:
// 1. ssd_chunk_products, one block per (b, chunk): C B^T on the causal
//    16 x 16 blocks by mma.sync m16n8k16 (bf16 x bf16 products are exact in
//    f32, f32 accumulation), once for all heads.  It writes G = C B^T and the
//    chunk's C and B^T, each in the register-fragment order in which the
//    scan's warps read them (every warp load is 512 contiguous bytes), to a
//    workspace the wrapper allocates, 128 KB per (b, chunk): 100 KB of it
//    written at N=128, 12.8 MB at the main shape, L2-resident.
// 2. ssd_scan_bf16, one block of 8 warps per (b, h, P-slice of 32 columns,
//    16 for P=16): 256 blocks at the main shape (512 for Jamba's P=128) and
//    2 blocks (16 warps) per SM.  The columns of y and of the state are
//    independent in p, so a slice walks its chunks in order with no traffic
//    between blocks and takes P=128 with no more shared memory.  (Splitting
//    the chunks instead would write and read back 134 MB of chunk states.)
//    Per chunk:
//      M x      M formed in registers from G's fragments, split into bf16
//               hi + lo, times x (bf16, exact): 2 passes.  The 36 causal
//               16 x 16 blocks of M go to the 8 warps 4 or 5 apiece, each
//               formed once; a row block split between two warps is summed
//               through shared memory, in a fixed order.  Below the diagonal
//               block, exp(cum_i - cum_j) is taken as exp(cum_i - cum_r)
//               exp(cum_r - cum_j), r the last step of j's block: both
//               factors at most 1, the second one per chunk.
//      C state  C (exact) times the state split into bf16 hi + lo: 2 passes;
//      update   B^T (exact) times w x split into hi + lo (w_j = exp(cum_last
//               - cum_j) dt_j), into the f32 state each warp keeps for its
//               16 state rows in accumulator registers across chunks: 2 passes.
//    A hi + lo split keeps 16 of f32's 24 significand bits and drops
//    |v| 2^-18 at most, so every product stays f32-accurate without TF32.
//    x and dt come in by cp.async one chunk ahead, into a second buffer;
//    x, w x and the state's hi/lo copy are read by ldmatrix (70 KB of shared
//    memory a block at a 32-column slice).  The fragment loads from the
//    workspace are issued in unrolled batches.
//    The slices of a head repeat M's formation and read G, C and B^T from L2
//    once per slice: 820 MB of L2 reads at the main shape.
// Ragged chunks (q < 128) are zero-filled past q (dt too, so they add
// nothing), and rows past q are not stored.
//
// f32 inputs (not on any model path): every product an f32 x f32 FMA, one
// block of 256 threads per (b, h, P-slice of up to 64 columns) walks its
// chunks in order with the (N, P-slice) state in shared memory and forms
// C B^T per head in f32; C and M are staged one half-chunk of 64 rows at a
// time (199 KB at N=128 and a 64-column slice).
//
// Masked entries of M (j > i) are never formed, so a NaN in B_j does not
// reach rows i < j of its chunk; the Pallas kernel forms NaN * 0 there.
//
// C interface for ctypes: returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ f32, FMA

constexpr int kQ = 128;        // the largest chunk
constexpr int kRT = 64;        // rows of one half-chunk: the C and M tiles
constexpr int kMaxN = 128;     // the largest state width
constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16 (columns), ty = tid / 16 (rows)

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

// One block per (b, h, P-slice of P columns) walks its chunks in order.
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ Cm, float* __restrict__ y, int S, int H, int Ptot,
             int N, int q) {
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
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * P;
  const float a = A[h];

  for (int i = tid; i < N16 * P; i += kThreads) st[i] = 0.f;

  for (int c = 0; c < S / q; ++c) {
    const size_t row0 = (size_t)b * S + (size_t)c * q;  // row (b, s) of the chunk's first step
    __syncthreads();  // the previous chunk is done with xs, bs and dtv
    for (int i = tid; i < kQ; i += kThreads) dtv[i] = i < q ? dt[(row0 + i) * H + h] : 0.f;
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i % P;
      xs[i] = r < q ? x[((row0 + r) * H + h) * Ptot + p0 + p] : 0.f;
    }
    for (int i = tid; i < kQ * N16; i += kThreads) {
      const int r = i / N16, n = i % N16;
      bs[r * LDB + n] = (r < q && n < N) ? Bm[(row0 + r) * N + n] : 0.f;
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
        cs[r * LDB + n] = (r0 + r < q && n < N) ? Cm[(row0 + r0 + r) * N + n] : 0.f;
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
          float* yrow = y + ((row0 + ig) * H + h) * Ptot + p0;
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

// ------------------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Row addresses of a 16 x 16 block at (r0, c0) of a row-major bf16 array in
// shared memory with rows of `ld` elements, for ldmatrix.x4.  "rc": the four
// 8 x 8 matrices go (r0, c0), (r0 + 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8),
// which gives an A fragment (rows = M) or, transposed, the B fragments of
// two n-tiles (rows = K).  "cr": (r0, c0), (r0, c0 + 8), (r0 + 8, c0),
// (r0 + 8, c0 + 8), which gives the B fragments of two n-tiles (rows = N)
// or, transposed, an A fragment (rows = K).
__device__ __forceinline__ uint32_t ldsm_rc(uint32_t base, int ld, int r0, int c0, int lane) {
  return base + ((r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + c0 + 8 * (lane >> 4)) * 2;
}
__device__ __forceinline__ uint32_t ldsm_cr(uint32_t base, int ld, int r0, int c0, int lane) {
  return base + ((r0 + (lane & 7) + 8 * (lane >> 4)) * ld + c0 + 8 * ((lane >> 3) & 1)) * 2;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi and lo with hi + lo = (a, b) to 2^-18 relative.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Workspace of one (b, chunk), in the fragment order of mma.m16n8k16:
//   G   [ib 8][jb 8][lane 32][8] f32: C B^T block (ib, jb) as two n-tiles'
//       accumulators (only jb <= ib are written and read);
//   Cf  [ib 8][kb 8][lane 32] uint4: A fragments of C (rows i, k = n);
//   Btf [nb 8][jb 8][lane 32] uint4: A fragments of B^T (rows n, k = j).
constexpr int kWsG = 64 * 32 * 8 * 4;
constexpr int kWsFrag = 64 * 32 * 16;
constexpr int kWsBytes = kWsG + 2 * kWsFrag;  // 128 KB
constexpr int kLdN = kMaxN + 8;               // padded smem row of a (Q, N) tile

constexpr int kProductsSmem = 2 * kQ * kLdN * 2;  // C and B tiles, bf16

__global__ void __launch_bounds__(kThreads)
ssd_chunk_products(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   uint8_t* __restrict__ ws, int S, int N, int q) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = cs + kQ * kLdN;
  const int c = blockIdx.x, b = blockIdx.y, n_c = gridDim.x;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int N16 = round16(N), nk = N16 / 16;
  const size_t row0 = (size_t)b * S + (size_t)c * q;
  // N is a multiple of 8, so each row is whole 16-byte vectors
  for (int i = tid; i < kQ * (N16 / 8); i += kThreads) {
    const int r = i / (N16 / 8), v = (i % (N16 / 8)) * 8;
    uint4 cv = make_uint4(0, 0, 0, 0), bv = make_uint4(0, 0, 0, 0);
    if (r < q && v < N) {
      cv = *reinterpret_cast<const uint4*>(Cm + (row0 + r) * N + v);
      bv = *reinterpret_cast<const uint4*>(Bm + (row0 + r) * N + v);
    }
    *reinterpret_cast<uint4*>(cs + r * kLdN + v) = cv;
    *reinterpret_cast<uint4*>(bs + r * kLdN + v) = bv;
  }
  __syncthreads();
  uint8_t* wsc = ws + (size_t)(b * n_c + c) * kWsBytes;
  float4* G = reinterpret_cast<float4*>(wsc);
  uint4* Cf = reinterpret_cast<uint4*>(wsc + kWsG);
  uint4* Btf = reinterpret_cast<uint4*>(wsc + kWsG + kWsFrag);
  const uint32_t cs_a = smem_u32(cs), bs_a = smem_u32(bs);

  for (int jb = 0; jb <= w; ++jb) {  // G block (w, jb): C rows 16w.., B rows 16jb..
    float acc[2][4] = {};
    for (int kb = 0; kb < nk; ++kb) {
      uint32_t a[4], bf[4];
      ldsm_x4(a, ldsm_rc(cs_a, kLdN, 16 * w, 16 * kb, lane));
      ldsm_x4(bf, ldsm_cr(bs_a, kLdN, 16 * jb, 16 * kb, lane));
      mma_bf16_16816(acc[0], a, bf[0], bf[1]);
      mma_bf16_16816(acc[1], a, bf[2], bf[3]);
    }
    float4* dst = G + ((w * 8 + jb) * 32 + lane) * 2;
    dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    dst[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
  for (int kb = 0; kb < nk; ++kb) {
    uint32_t a[4];
    ldsm_x4(a, ldsm_rc(cs_a, kLdN, 16 * w, 16 * kb, lane));
    Cf[(w * 8 + kb) * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
  }
  if (w < nk) {
    for (int jb = 0; jb < 8; ++jb) {
      uint32_t a[4];
      ldsm_x4_t(a, ldsm_cr(bs_a, kLdN, 16 * jb, 16 * w, lane));
      Btf[(w * 8 + jb) * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
    }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// acc (16 rows of y, the slice's PS columns) += M x over one causal 16 x 16
// block (ib, jb) of M, formed here from gv, that block of C B^T: M[i][j] =
// G[i][j] L[i][j] dt[j], L = exp(cum_i - cum_j) for j <= i.  Below the
// diagonal block it is taken as exp(cum_i - cum_r) ev[j], r the last step of
// j's block: both factors are at most 1 (cum falls along the chunk), so
// neither overflows.  M is split into bf16 hi + lo, two passes against x.
template <int PS>
__device__ __forceinline__ void m_x_block(float (&acc)[PS / 8][4], const float4 (&gv)[2],
                                          int ib, int jb, const float* cum, const float* dtv,
                                          const float* ev, uint32_t xs_a, int lane) {
  const int g = lane >> 2, t = lane & 3, i0 = 16 * ib + g;
  float mv[2][4];
  if (jb < ib) {
    const float cr = cum[16 * jb + 15];
    const float ai[2] = {expf(cum[i0] - cr), expf(cum[i0 + 8] - cr)};
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
      const float gs[4] = {gv[tile].x, gv[tile].y, gv[tile].z, gv[tile].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mv[tile][e] = gs[e] * ai[e >> 1] * ev[16 * jb + 8 * tile + 2 * t + (e & 1)];
    }
  } else {
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
      const float gs[4] = {gv[tile].x, gv[tile].y, gv[tile].z, gv[tile].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1), j = 16 * jb + 8 * tile + 2 * t + (e & 1);
        mv[tile][e] = j <= i ? gs[e] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
      }
    }
  }
  uint32_t mh[4], ml[4];
  split_bf16(mv[0][0], mv[0][1], mh[0], ml[0]);
  split_bf16(mv[0][2], mv[0][3], mh[1], ml[1]);
  split_bf16(mv[1][0], mv[1][1], mh[2], ml[2]);
  split_bf16(mv[1][2], mv[1][3], mh[3], ml[3]);
#pragma unroll
  for (int np = 0; np < PS / 16; ++np) {
    uint32_t xb[4];
    ldsm_x4_t(xb, ldsm_rc(xs_a, PS + 8, 16 * jb, 16 * np, lane));
    mma_bf16_16816(acc[2 * np], mh, xb[0], xb[1]);
    mma_bf16_16816(acc[2 * np], ml, xb[0], xb[1]);
    mma_bf16_16816(acc[2 * np + 1], mh, xb[2], xb[3]);
    mma_bf16_16816(acc[2 * np + 1], ml, xb[2], xb[3]);
  }
}

template <int PS>
constexpr int scan_smem_bytes() {
  return 2 * (2 * kQ * (PS + 8)        // xs: x slice [2][kQ][PS + 8] bf16, double-buffered
              + 2 * kQ * (PS + 8)      // wxh, wxl: (w x) hi and lo
              + 2 * kMaxN * (PS + 8))  // sth, stl: state hi and lo [N16][PS + 8]
         + 4 * 4 * kQ                  // dtv [2][kQ], cum, ev
         + 4 * 4 * 32 * (PS / 2);      // part: [4 warp pairs][32 lanes][PS / 2] f32
}

template <int PS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const uint8_t* __restrict__ ws,
              float* __restrict__ y, int S, int H, int P, int N, int q) {
  constexpr int LD = PS + 8;  // padded smem row: conflict-free ldmatrix
  constexpr int NT = PS / 8;  // n-tiles of a (16, PS) output
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* xs0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* wxh = xs0 + 2 * kQ * LD;
  bf16* wxl = wxh + kQ * LD;
  bf16* sth = wxl + kQ * LD;
  bf16* stl = sth + kMaxN * LD;
  float* dtv0 = reinterpret_cast<float*>(stl + kMaxN * LD);
  float* cum = dtv0 + 2 * kQ;
  float* ev = cum + kQ;  // ev[j] = exp(cum[j | 15] - cum[j]) dt[j]: at most dt[j]
  float4* part = reinterpret_cast<float4*>(ev + kQ);  // one warp's partial y, lane-major

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_c = S / q, nk = round16(N) / 16, nj = (q + 15) / 16;
  const float a = A[h];
  const uint32_t wxh_a = smem_u32(wxh), wxl_a = smem_u32(wxl);
  const uint32_t sth_a = smem_u32(sth), stl_a = smem_u32(stl);

  // chunk c's dt and x slice into buffer c % 2, zero past q, asynchronously
  auto prefetch = [&](int c) {
    const size_t row0 = (size_t)b * S + (size_t)c * q;
    bf16* xs = xs0 + (c & 1) * kQ * LD;
    float* dtv = dtv0 + (c & 1) * kQ;
    for (int i = tid; i < kQ; i += kThreads)
      cp_async4(smem_u32(dtv + i), i < q ? dt + (row0 + i) * H + h : dt, i < q);
    for (int i = tid; i < kQ * (PS / 8); i += kThreads) {
      const int r = i / (PS / 8), v = (i % (PS / 8)) * 8;
      cp_async16(smem_u32(xs + r * LD + v), r < q ? x + ((row0 + r) * H + h) * P + p0 + v : x,
                 r < q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int i = tid; i < kMaxN * LD; i += kThreads) sth[i] = stl[i] = __float2bfloat16(0.f);
  float st[NT][4] = {};  // state rows 16w + g (+ 8), columns 8 nt + 2t (+ 1), in f32
  prefetch(0);

  for (int c = 0; c < n_c; ++c) {
    const size_t row0 = (size_t)b * S + (size_t)c * q;
    const uint8_t* wsc = ws + (size_t)(b * n_c + c) * kWsBytes;
    const float4* G = reinterpret_cast<const float4*>(wsc);
    const uint4* Cf = reinterpret_cast<const uint4*>(wsc + kWsG);
    const uint4* Btf = reinterpret_cast<const uint4*>(wsc + kWsG + kWsFrag);
    const bf16* xs = xs0 + (c & 1) * kQ * LD;
    const float* dtv = dtv0 + (c & 1) * kQ;
    const uint32_t xs_a = smem_u32(xs);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // chunk c's inputs have landed; the previous chunk is done with the
    // other buffer, wx, cum and ev
    __syncthreads();
    if (c + 1 < n_c) prefetch(c + 1);
    if (tid < 32) {  // cum = inclusive cumsum of dt * a: 4 steps per lane, then a warp scan
      float s4[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += dtv[4 * tid + k] * a;
        s4[k] = run;
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
      for (int k = 0; k < 4; ++k) cum[4 * tid + k] = excl + s4[k];
    }
    __syncthreads();
    const float cum_last = cum[q - 1];
    for (int i = tid; i < kQ * (PS / 2); i += kThreads) {  // w x, split into hi + lo
      const int r = i / (PS / 2), v = (i % (PS / 2)) * 2;
      const float wr = expf(cum_last - cum[r]) * dtv[r];
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + r * LD + v));
      uint32_t hi, lo;
      split_bf16(wr * xv.x, wr * xv.y, hi, lo);
      *reinterpret_cast<uint32_t*>(wxh + r * LD + v) = hi;
      *reinterpret_cast<uint32_t*>(wxl + r * LD + v) = lo;
    }
    for (int j = tid; j < kQ; j += kThreads) ev[j] = expf(cum[j | 15] - cum[j]) * dtv[j];
    __syncthreads();

    // y = M x + exp(cum) C state.  The 36 causal blocks of M go to the
    // warps 4 or 5 apiece, each formed once: warp pair p (warps 2p, 2p + 1)
    // owns row blocks ra = p (p + 1 blocks) and rb = 7 - p (8 - p blocks).
    // Warp 2p takes all of ra and blocks 0..3-p of rb, whose partial sum it
    // hands to warp 2p + 1 through shared memory; warp 2p + 1 takes blocks
    // 4-p..7-p of rb.  Each warp then owns one row block: its C state and its
    // y.  The workspace's fragments are loaded one block ahead.
    const int pair = w >> 1, ra = pair, rb = 7 - pair;
    const int own = (w & 1) ? rb : ra, i0 = 16 * own + g;
    float acc[NT][4] = {}, yo[NT][4] = {};
    auto m_x_run = [&](float (&dst)[NT][4], int ib, int jb_lo, int jb_hi) {
      if (ib >= nj) return;  // rows past q
      float4 gv[2] = {G[((ib * 8 + jb_lo) * 32 + lane) * 2],
                      G[((ib * 8 + jb_lo) * 32 + lane) * 2 + 1]};
      for (int jb = jb_lo; jb <= jb_hi; ++jb) {
        float4 next[2] = {gv[0], gv[1]};
        if (jb < jb_hi) {
          next[0] = G[((ib * 8 + jb + 1) * 32 + lane) * 2];
          next[1] = G[((ib * 8 + jb + 1) * 32 + lane) * 2 + 1];
        }
        m_x_block<PS>(dst, gv, ib, jb, cum, dtv, ev, xs_a, lane);
        gv[0] = next[0];
        gv[1] = next[1];
      }
    };
    if (w & 1) {
      m_x_run(acc, rb, 4 - pair, 7 - pair);
    } else {
      m_x_run(acc, ra, 0, ra);
      float pb[NT][4] = {};
      m_x_run(pb, rb, 0, 3 - pair);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        part[(pair * 32 + lane) * NT + nt] =
            make_float4(pb[nt][0], pb[nt][1], pb[nt][2], pb[nt][3]);
    }
    if (own < nj) {
#pragma unroll
      for (int kb0 = 0; kb0 < 8; kb0 += 4) {
        if (kb0 < nk) {
          uint4 cv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cv[u] = Cf[(own * 8 + kb0 + u) * 32 + lane];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int kb = kb0 + u;
            if (kb < nk) {
              const uint32_t cf[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
#pragma unroll
              for (int np = 0; np < NT / 2; ++np) {
                uint32_t sh[4], sl[4];
                ldsm_x4_t(sh, ldsm_rc(sth_a, LD, 16 * kb, 16 * np, lane));
                ldsm_x4_t(sl, ldsm_rc(stl_a, LD, 16 * kb, 16 * np, lane));
                mma_bf16_16816(yo[2 * np], cf, sh[0], sh[1]);
                mma_bf16_16816(yo[2 * np], cf, sl[0], sl[1]);
                mma_bf16_16816(yo[2 * np + 1], cf, sh[2], sh[3]);
                mma_bf16_16816(yo[2 * np + 1], cf, sl[2], sl[3]);
              }
            }
          }
        }
      }
    }

    // state' = state * exp(cum_last) + B^T (w x), for this warp's state rows.
    if (w < nk) {
      const float decay = expf(cum_last);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= decay;
#pragma unroll
      for (int jb0 = 0; jb0 < 8; jb0 += 4) {
        if (jb0 < nj) {
          uint4 bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) bv[u] = Btf[(w * 8 + jb0 + u) * 32 + lane];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int jb = jb0 + u;
            if (jb < nj) {
              const uint32_t bt[4] = {bv[u].x, bv[u].y, bv[u].z, bv[u].w};
#pragma unroll
              for (int np = 0; np < NT / 2; ++np) {
                uint32_t vh[4], vl[4];
                ldsm_x4_t(vh, ldsm_rc(wxh_a, LD, 16 * jb, 16 * np, lane));
                ldsm_x4_t(vl, ldsm_rc(wxl_a, LD, 16 * jb, 16 * np, lane));
                mma_bf16_16816(st[2 * np], bt, vh[0], vh[1]);
                mma_bf16_16816(st[2 * np], bt, vl[0], vl[1]);
                mma_bf16_16816(st[2 * np + 1], bt, vh[2], vh[3]);
                mma_bf16_16816(st[2 * np + 1], bt, vl[2], vl[3]);
              }
            }
          }
        }
      }
    }
    // every warp is done reading the old state's hi and lo, and the partial
    // sums of M x are in shared memory
    __syncthreads();
    if (own < nj) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = i0 + 8 * hr;
        if (i < q) {
          const float e = expf(cum[i]);
          float* yrow = y + ((row0 + i) * H + h) * P + p0 + 2 * t;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float d0 = acc[nt][2 * hr], d1 = acc[nt][2 * hr + 1];
            if (w & 1) {  // add warp 2p's part of row block rb
              const float4 pv = part[(pair * 32 + lane) * NT + nt];
              d0 += hr ? pv.z : pv.x;
              d1 += hr ? pv.w : pv.y;
            }
            *reinterpret_cast<float2*>(yrow + 8 * nt) =
                make_float2(d0 + e * yo[nt][2 * hr], d1 + e * yo[nt][2 * hr + 1]);
          }
        }
      }
    }
    if (w < nk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int n = 16 * w + g + 8 * hr, col = 8 * nt + 2 * t;
          uint32_t hi, lo;
          split_bf16(st[nt][2 * hr], st[nt][2 * hr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sth + n * LD + col) = hi;
          *reinterpret_cast<uint32_t*>(stl + n * LD + col) = lo;
        }
    }
  }
}

template <int PS>
cudaError_t launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* ws, int B, int S, int H, int P, int N,
                        int q, cudaStream_t stream) {
  // Raise the dynamic shared-memory limits once, on the first launch (which
  // happens before any CUDA graph capture that the caller starts).
  static cudaError_t configured = [] {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_products, cudaFuncAttributeMaxDynamicSharedMemorySize, kProductsSmem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(ssd_scan_bf16<PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                scan_smem_bytes<PS>());
  }();
  if (configured != cudaSuccess) return configured;
  ssd_chunk_products<<<dim3(S / q, B), kThreads, kProductsSmem, stream>>>(
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<uint8_t*>(ws),
      S, N, q);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bf16<PS><<<dim3(P / PS, H, B), kThreads, scan_smem_bytes<PS>(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const uint8_t*>(ws), static_cast<float*>(y),
      S, H, P, N, q);
  return cudaGetLastError();
}

template <int PS>
cudaError_t launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, int B, int S, int H, int P, int N, int q,
                       cudaStream_t stream) {
  static cudaError_t configured = cudaFuncSetAttribute(
      ssd_scan_f32<PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(kMaxN, PS) * sizeof(float)));
  if (configured != cudaSuccess) return configured;
  const size_t smem = smem_floats(round16(N), PS) * sizeof(float);
  ssd_scan_f32<PS><<<dim3(H, B, P / PS), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), S, H, P, N, q);
  return cudaGetLastError();
}

bool valid(int dtype, int B, int S, int H, int P, int N, int q) {
  return (dtype == 0 || dtype == 1) && B >= 1 && B <= 65535 && H >= 1 && H <= 65535 &&
         (P == 16 || P == 32 || P == 64 || P == 128) && N >= 8 && N <= kMaxN && N % 8 == 0 &&
         q >= 1 && q <= kQ && S % q == 0;
}

}  // namespace

// Bytes of workspace that repro_ssd_scan_fwd needs (the bf16 path's chunk
// products); 0 for float32 inputs or invalid arguments.
extern "C" long long repro_ssd_scan_workspace_bytes(int dtype, int B, int S, int q) {
  if (dtype != 1 || B < 1 || q < 1 || S % q) return 0;
  return (long long)B * (S / q) * kWsBytes;
}

// Dynamic shared memory of one block, in bytes, of kernel 0 (ssd_scan_f32),
// 1 (ssd_scan_bf16) or 2 (ssd_chunk_products) for head dim P and state N.
extern "C" int repro_ssd_scan_smem_bytes(int kernel, int P, int N) {
  switch (kernel) {
    case 0: return (int)(smem_floats(round16(N), P < 64 ? P : 64) * sizeof(float));
    case 1: return P == 16 ? scan_smem_bytes<16>() : scan_smem_bytes<32>();
    case 2: return kProductsSmem;
  }
  return 0;
}

// dtype of x, Bm and Cm: 0 = float32, 1 = bfloat16; dt, A and y are float32.
// ws: repro_ssd_scan_workspace_bytes of device memory (unused for float32).
// Returns a cudaError_t.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* y, void* ws,
                                  int dtype, int B, int S, int H, int P, int N, int q,
                                  void* stream) {
  if (!valid(dtype, B, S, H, P, N, q) || (dtype == 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (P == 16) return launch_bf16<16>(x, dt, A, Bm, Cm, y, ws, B, S, H, P, N, q, s);
    return launch_bf16<32>(x, dt, A, Bm, Cm, y, ws, B, S, H, P, N, q, s);
  }
  switch (P) {
    case 16: return launch_f32<16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, q, s);
    case 32: return launch_f32<32>(x, dt, A, Bm, Cm, y, B, S, H, P, N, q, s);
    default: return launch_f32<64>(x, dt, A, Bm, Cm, y, B, S, H, P, N, q, s);
  }
}

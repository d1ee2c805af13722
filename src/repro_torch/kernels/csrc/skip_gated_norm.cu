// The Mamba-2 mixer's epilogue for Hopper, sm_90a: the D skip, the cast to
// the model's dtype and the gated RMS norm, in one pass over K3's output.
//
// Replaces no Pallas kernel: the JAX package leaves the skip and the norm to
// XLA (src/repro/models/ssm.py, ssm_fwd; src/repro/models/modules.py,
// gated_rmsnorm).  It was added because the port's PyTorch expression
// (models/ssm.py ssm_fwd, then models/modules.py gated_rmsnorm) runs about a
// dozen elementwise passes through f32 temporaries: xh.float(), D * x, the
// sum, the cast, z.float(), silu, its cast, the product, .float(), the
// square, the mean, the scaling and the casts.  At granite-4.0-h-small's
// prefill of 8 x 4096 tokens (8192 channels, bf16) that is about 25 GB of
// traffic a mixer, about 10 ms.
//
// What bounds it: bytes.  Each token row reads K3's f32 y, x and z once and
// writes the output once (2.68 GB at granite's shape: 0.80 ms at 3.35 TB/s);
// D and the norm's scale are a few KB that stay in L1 and L2.  The
// arithmetic is about 40 instructions an element (silu's expf and IEEE
// division the most of them), under half of what the bytes leave room for.
//
// Design.  A block owns one token row (up to 256 threads).  Thread t takes
// the 4-channel units t, t + T, t + 2T, ... of the row (T the block's
// threads): 16-byte loads of y, 8-byte (bf16) or 16-byte (f32) loads of x,
// z and the scale and stores of the output, neighbouring threads on
// neighbouring addresses.  The row stays in registers between the reduction
// and the epilogue (each unit's gated product, rounded to the model dtype,
// so nothing is read twice from device memory.  Sums of squares of a
// group: each unit's four squares, then across the unit's lanes by warp
// shuffles within aligned runs of min(group / 4, 32) lanes (a group of up
// to 128 channels never leaves its warp); a group wider than a warp adds
// its warps' sums from shared memory, one warp a group.  Groups of 4 x 2^k
// channels up to 128, and any multiple of 128, are taken.
//
// Rounding: the reference's, bit for bit, except for the order of the
// group's sum.  With round() to the model dtype (round to nearest even; the
// identity in float32), for each channel c of head h:
//   u = round(y + round_f32(D[h] * x))          (two f32 operations, no FMA)
//   a = round(z / (1 + expf(-z)))               (ATen's silu, in f32)
//   g = round(u * a)
//   var = (sum over the group of g * g) * (1 / group)     (ATen's mean)
//   r = rsqrtf(var + eps)                       (ATen's rsqrt)
//   out = round(round(g * r) * s[c])
// The _rn intrinsics are never contracted into an FMA or approximated; the
// build uses no fast math.  Given the same group sums, the output equals the
// plain version's bit for bit; the kernel writes each group's r on request,
// so that a check can hold it to that.
//
// C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // most threads a block (a row)
constexpr int kMaxSteps = 16;  // units a thread: rows of up to 16,384 channels

struct Args {
  const float4* y;  // (rows, units) K3's output, f32
  const void* x;    // (rows, units) the conv's output, model dtype
  const float* D;   // (heads,) f32
  const void* z;    // (rows, units) model dtype
  const void* s;    // (units,) the norm's scale, model dtype
  void* out;        // (rows, units) model dtype
  float* rstd;      // (rows, groups) or null
  int units;        // 4-channel units a row
  int head_dim;     // channels a head
  int group_units;  // units a group
  float factor;     // 1 / group
  float eps;
};

// Four channels of the model dtype T: loaded, widened to f32, rounded to T
// and packed again.
template <typename T> struct Io;

template <> struct Io<float> {
  using Vec = float4;
  static __device__ __forceinline__ void unpack(Vec v, float f[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ Vec pack(const float f[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <> struct Io<__nv_bfloat16> {
  using Vec = uint2;
  static __device__ __forceinline__ float2 pair(unsigned int v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  }
  static __device__ __forceinline__ unsigned int bits(float a, float b) {
    __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<unsigned int*>(&p);
  }
  static __device__ __forceinline__ void unpack(Vec v, float f[4]) {
    const float2 a = pair(v.x), b = pair(v.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  static __device__ __forceinline__ Vec pack(const float f[4]) {
    return make_uint2(bits(f[0], f[1]), bits(f[2], f[3]));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// y + D * x as the reference forms it: an f32 product, then an f32 sum
__device__ __forceinline__ float skip_sum(float y, float d, float x) {
  return __fadd_rn(y, __fmul_rn(d, x));
}

// ATen's silu: v / (1 + exp(-v)), IEEE division, no fast math
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

template <typename T, int kSteps>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 4 : 2)
skip_gated_norm(Args a) {
  using IO = Io<T>;
  using Vec = typename IO::Vec;
  extern __shared__ float smem[];
  const int t = (int)threadIdx.x, lane = t % 32, nt = (int)blockDim.x;
  const int units = a.units, ug = a.group_units;
  const int seg = ug < 32 ? ug : 32;  // lanes of one group in a warp
  const long long row = blockIdx.x;
  const float4* y = a.y + row * units;
  const Vec* x = static_cast<const Vec*>(a.x) + row * units;
  const Vec* z = static_cast<const Vec*>(a.z) + row * units;

  // the gated products of this thread's units, and each run's sum of squares
  Vec g[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int u = k * nt + t;
    float acc = 0.f;
    if (u < units) {
      const float4 yv = __ldg(y + u);
      const float yf[4] = {yv.x, yv.y, yv.z, yv.w};
      float xf[4], zf[4], gf[4];
      IO::unpack(__ldg(x + u), xf);
      IO::unpack(__ldg(z + u), zf);
      const float d = __ldg(a.D + u * 4 / a.head_dim);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float uv = IO::round(skip_sum(yf[i], d, xf[i]));
        gf[i] = IO::round(__fmul_rn(uv, IO::round(silu(zf[i]))));
        acc = __fadd_rn(acc, __fmul_rn(gf[i], gf[i]));
      }
      g[k] = IO::pack(gf);
    }
    for (int off = 1; off < seg; off <<= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (u < units && lane % seg == 0) smem[u / seg] = acc;
  }

  // each group's sum: a run's sum, or (groups wider than a warp) its runs'
  // sums added by one warp
  const float* gsum = smem;
  if (ug > 32) {
    __syncthreads();
    float* sums = smem + units / 32;
    const int per = ug / 32, groups = units / ug;
    for (int gi = t / 32; gi < groups; gi += nt / 32) {
      float v = 0.f;
      for (int i = lane; i < per; i += 32) v = __fadd_rn(v, smem[gi * per + i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) sums[gi] = v;
    }
    gsum = sums;
  }
  __syncthreads();

  const Vec* s = static_cast<const Vec*>(a.s);
  Vec* out = static_cast<Vec*>(a.out) + row * units;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int u = k * nt + t;
    if (u >= units) break;
    const int gi = u / ug;
    const float sum = gsum[gi];
    const float r = rsqrtf(__fadd_rn(__fmul_rn(sum, a.factor), a.eps));
    if (a.rstd != nullptr && u % ug == 0) a.rstd[row * (units / ug) + gi] = r;
    float gf[4], sf[4], o[4];
    IO::unpack(g[k], gf);
    IO::unpack(__ldg(s + u), sf);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = IO::round(__fmul_rn(IO::round(__fmul_rn(gf[i], r)), sf[i]));
    out[u] = IO::pack(o);
  }
}

template <typename T, int kSteps>
int launch(const Args& a, long long rows, int threads, cudaStream_t st) {
  const int seg = a.group_units < 32 ? a.group_units : 32;
  size_t smem = (size_t)(a.units / seg) * sizeof(float);
  if (a.group_units > 32) smem += (size_t)(a.units / a.group_units) * sizeof(float);
  skip_gated_norm<T, kSteps><<<(unsigned)rows, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_steps(const Args& a, long long rows, int threads, int steps, cudaStream_t st) {
  if (steps <= 1) return launch<T, 1>(a, rows, threads, st);
  if (steps <= 2) return launch<T, 2>(a, rows, threads, st);
  if (steps <= 4) return launch<T, 4>(a, rows, threads, st);
  if (steps <= 8) return launch<T, 8>(a, rows, threads, st);
  return launch<T, kMaxSteps>(a, rows, threads, st);
}

}  // namespace

// out (rows, width) = the gated RMS norm, over groups of `group` channels,
// of round(y + D * x) gated by silu(z), times s; y (rows, width) f32, x, z
// (rows, width), s (width,) in the model dtype, D (width / head_dim,) f32.
// rstd (rows, width / group) f32 receives each group's 1 / sqrt(var + eps)
// unless it is null.  dtype: 0 = float32, 1 = bfloat16; every pointer
// 16-byte aligned (8-byte for bf16 x, z, s and out), every tensor
// contiguous.  Returns a cudaError_t.
extern "C" int repro_skip_gated_norm(const void* y, const void* x, const void* D, const void* z,
                                     const void* s, void* out, void* rstd, long long rows,
                                     int width, int head_dim, int group, float eps, int dtype,
                                     void* stream) {
  if ((dtype != 0 && dtype != 1) || rows < 1 || rows > 0x7fffffffLL || width < 4 ||
      width % 4 || width > 4 * kThreads * kMaxSteps || head_dim < 4 || head_dim % 4 ||
      width % head_dim || group < 4 || group % 4 || width % group)
    return cudaErrorInvalidValue;
  const int ug = group / 4;
  if (ug > 32 ? ug % 32 : 32 % ug) return cudaErrorInvalidValue;
  const size_t vec = dtype == 0 ? 16 : 8;
  if (reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(rstd) % 4 ||
      reinterpret_cast<uintptr_t>(D) % 4)
    return cudaErrorInvalidValue;
  const void* vecs[] = {x, z, s, out};
  for (const void* p : vecs)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % vec) return cudaErrorInvalidValue;
  if (y == nullptr || D == nullptr) return cudaErrorInvalidValue;
  Args a = {static_cast<const float4*>(y), x, static_cast<const float*>(D), z, s, out,
            static_cast<float*>(rstd), width / 4, head_dim, ug, 1.f / (float)group, eps};
  const int units = width / 4;
  const int threads = units < kThreads ? (units + 31) / 32 * 32 : kThreads;
  const int steps = (units + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_steps<__nv_bfloat16>(a, rows, threads, steps, st);
  return launch_steps<float>(a, rows, threads, steps, st);
}

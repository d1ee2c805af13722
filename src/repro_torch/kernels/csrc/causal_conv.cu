// The Mamba-2 mixer's depthwise causal convs, their biases and silu for
// Hopper, sm_90a: x, B and C of one mixer in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves the conv to XLA
// (src/repro/models/ssm.py, _causal_conv).  It was added because the port's
// PyTorch expression (models/ssm.py, _causal_conv, then F.silu) pads the
// input, fills a zeroed output, and runs a multiply and an add for each of
// the K taps, then the bias and silu: about 13 launches and 13 full passes
// over the tensor for each of the three inputs.  At granite-4.0-h-small's
// prefill of 8 x 4096 tokens (x 8192 wide, B and C 128 wide, K = 4, bf16)
// that is about 14 GB of traffic a mixer for 1.1 GB of input and output.
//
// What bounds it: bytes.  Each input element is read once and each output
// element written once (1.107 GB at granite's shape: 0.33 ms at 3.35 TB/s).
// The arithmetic comes close: silu's expf and IEEE division take about 20
// instructions an element in f32, two of them on the special-function
// units, so the taps run on bf16 pairs (two lanes an instruction) and the
// block is capped at 64 registers a thread (__launch_bounds__(128, 8): 32
// warps an SM, enough loads in flight to cover HBM's latency).
//
// Design.  A block of 128 threads is one warp across 32 channel vectors (16
// bytes each: 8 bf16 or 4 float channels) times 4 warps, each on its own
// run of kRows sequence rows of one sequence: 32 x 4 x kRows vectors of one
// input.  The grid's x walks the channel tiles of the inputs one after
// another (a table of up to three inputs, each with its own width, weights,
// bias and output), its y the row runs, its z the batch.  A thread holds
// its vector's K weights and bias in registers and walks down its rows
// with a window of the K - 1 previous inputs in registers, loading kBatch
// rows before it computes them, so every input byte is read from HBM once,
// plus K - 1 halo rows a run (mostly L1 or L2 hits: the warp above read
// them).  Rows before position 0 of each sequence are zeros; a run never
// reads the previous sequence's tail.  Loads and stores are 16 bytes, a
// warp's 32 lanes on 512 neighbouring bytes of a row.
//
// Rounding: the reference's, bit for bit.  With round() to the tensor's type
// (round to nearest even; the identity in float32), each output element is
//   acc = +0.0;  acc = round(acc + round(x[t - K + 1 + k] * w[k])),  k = 0 .. K-1
//   acc = round(acc + bias)                 (when there is a bias)
//   out = round(acc / (1 + expf(-acc)))     (ATen's silu, in f32)
// with the taps that fall before position 0 as products of zero: the
// sequence of `out = out + xp[:, k:k+S] * w[k]` on a zero-padded xp starting
// from zeros_like, then `+ b` and F.silu.  The _rn intrinsics are never
// contracted into an FMA or approximated; the build uses no fast math.
//
// C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxInputs = 3;
constexpr int kMaxTaps = 8;
constexpr int kLanes = 32;  // channel vectors a block: one warp across
constexpr int kWarps = 4;   // row runs a block, one a warp
constexpr int kRows = 32;   // rows a run
constexpr int kBatch = 4;   // rows loaded before they are computed

struct Input {
  const uint4* x;  // (batch, seq, nv) vectors
  const uint4* w;  // (K, nv)
  const uint4* b;  // (nv,) or null
  uint4* y;        // (batch, seq, nv)
  int nv;          // 16-byte vectors a row
  int first_tile;  // the first blockIdx.x of this input
};

struct Inputs {
  Input in[kMaxInputs];
};

// Lane-wise arithmetic on a 16-byte vector of T, rounded to T after each
// operation as the reference rounds it.  The reference forms a bf16 product
// or sum in f32 and rounds it to bf16: a product of two bf16 is exact in f32,
// and a sum is exact in f32 unless the exponents differ by 16 or more, where
// the smaller addend lies far below half a bf16 ulp of the larger and both
// roundings give the larger.  So bf16x2's correctly rounded mul.rn and add.rn
// (__hmul2_rn, __hadd2_rn: never contracted into an FMA) give its bits.
template <typename T> struct Lanes;

template <> struct Lanes<float> {
  static __device__ __forceinline__ uint4 mul(uint4 a, uint4 b) {
    return make_uint4(
        __float_as_uint(__fmul_rn(__uint_as_float(a.x), __uint_as_float(b.x))),
        __float_as_uint(__fmul_rn(__uint_as_float(a.y), __uint_as_float(b.y))),
        __float_as_uint(__fmul_rn(__uint_as_float(a.z), __uint_as_float(b.z))),
        __float_as_uint(__fmul_rn(__uint_as_float(a.w), __uint_as_float(b.w))));
  }
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    return make_uint4(
        __float_as_uint(__fadd_rn(__uint_as_float(a.x), __uint_as_float(b.x))),
        __float_as_uint(__fadd_rn(__uint_as_float(a.y), __uint_as_float(b.y))),
        __float_as_uint(__fadd_rn(__uint_as_float(a.z), __uint_as_float(b.z))),
        __float_as_uint(__fadd_rn(__uint_as_float(a.w), __uint_as_float(b.w))));
  }
  // silu of each lane, in f32
  static __device__ __forceinline__ uint4 silu(uint4 a) {
    return make_uint4(__float_as_uint(silu1(__uint_as_float(a.x))),
                      __float_as_uint(silu1(__uint_as_float(a.y))),
                      __float_as_uint(silu1(__uint_as_float(a.z))),
                      __float_as_uint(silu1(__uint_as_float(a.w))));
  }
  // ATen's silu: v / (1 + exp(-v)), IEEE division, no fast math
  static __device__ __forceinline__ float silu1(float v) {
    return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
  }
};

template <> struct Lanes<__nv_bfloat16> {
  using P = __nv_bfloat162;
  static __device__ __forceinline__ unsigned int bits(P v) {
    return *reinterpret_cast<unsigned int*>(&v);
  }
  static __device__ __forceinline__ P pair(unsigned int v) {
    return *reinterpret_cast<P*>(&v);
  }
  static __device__ __forceinline__ uint4 mul(uint4 a, uint4 b) {
    return make_uint4(bits(__hmul2_rn(pair(a.x), pair(b.x))), bits(__hmul2_rn(pair(a.y), pair(b.y))),
                      bits(__hmul2_rn(pair(a.z), pair(b.z))),
                      bits(__hmul2_rn(pair(a.w), pair(b.w))));
  }
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    return make_uint4(bits(__hadd2_rn(pair(a.x), pair(b.x))), bits(__hadd2_rn(pair(a.y), pair(b.y))),
                      bits(__hadd2_rn(pair(a.z), pair(b.z))),
                      bits(__hadd2_rn(pair(a.w), pair(b.w))));
  }
  // silu of each lane in f32, rounded once to bf16
  static __device__ __forceinline__ unsigned int silu2(unsigned int v) {
    const float2 f = __bfloat1622float2(pair(v));
    return bits(__floats2bfloat162_rn(Lanes<float>::silu1(f.x), Lanes<float>::silu1(f.y)));
  }
  static __device__ __forceinline__ uint4 silu(uint4 a) {
    return make_uint4(silu2(a.x), silu2(a.y), silu2(a.z), silu2(a.w));
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(kLanes * kWarps, 8)
causal_conv_silu(Inputs args, int n, long long seq) {
  using L = Lanes<T>;
  // the input this block's channel tile belongs to
  Input in = args.in[0];
  if (n > 1 && (int)blockIdx.x >= args.in[1].first_tile) in = args.in[1];
  if (n > 2 && (int)blockIdx.x >= args.in[2].first_tile) in = args.in[2];
  const int nv = in.nv;
  const int v = ((int)blockIdx.x - in.first_tile) * kLanes + (int)(threadIdx.x % kLanes);
  const long long t0 = ((long long)blockIdx.y * kWarps + threadIdx.x / kLanes) * kRows;
  if (v >= nv || t0 >= seq) return;

  uint4 w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = __ldg(in.w + (long long)k * nv + v);
  const bool has_bias = in.b != nullptr;
  const uint4 bias = has_bias ? __ldg(in.b + v) : make_uint4(0, 0, 0, 0);

  const long long base = (long long)blockIdx.z * seq * nv + v;  // row 0 of this sequence
  const uint4* x = in.x + base;
  uint4* y = in.y + base;
  // win[j] holds row t - (K - 1) + j of the rows being computed from t on;
  // rows before 0 are zeros
  uint4 win[K - 1 + kBatch];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const long long t = t0 - (K - 1) + j;
    win[j] = t >= 0 ? __ldg(x + t * nv) : make_uint4(0, 0, 0, 0);
  }
  const long long end = t0 + kRows < seq ? t0 + kRows : seq;
  for (long long t = t0; t < end; t += kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      win[K - 1 + u] = t + u < end ? __ldg(x + (t + u) * nv) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t + u >= end) break;
      uint4 acc = make_uint4(0, 0, 0, 0);  // +0.0 in every lane
#pragma unroll
      for (int k = 0; k < K; ++k) acc = L::add(acc, L::mul(win[u + k], w[k]));
      if (has_bias) acc = L::add(acc, bias);
      y[(t + u) * nv] = L::silu(acc);
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j) win[j] = win[j + kBatch];
  }
}

template <typename T, int K>
int launch(const Inputs& args, int n, long long batch, long long seq, int tiles,
           cudaStream_t s) {
  const long long runs = (seq + kWarps * kRows - 1) / (kWarps * kRows);
  const dim3 grid((unsigned)tiles, (unsigned)runs, (unsigned)batch);
  causal_conv_silu<T, K><<<grid, kLanes * kWarps, 0, s>>>(args, n, seq);
  return cudaGetLastError();
}

template <typename T>
int launch_taps(const Inputs& args, int n, long long batch, long long seq, int taps,
                int tiles, cudaStream_t s) {
  switch (taps) {
    case 1: return launch<T, 1>(args, n, batch, seq, tiles, s);
    case 2: return launch<T, 2>(args, n, batch, seq, tiles, s);
    case 3: return launch<T, 3>(args, n, batch, seq, tiles, s);
    case 4: return launch<T, 4>(args, n, batch, seq, tiles, s);
    case 5: return launch<T, 5>(args, n, batch, seq, tiles, s);
    case 6: return launch<T, 6>(args, n, batch, seq, tiles, s);
    case 7: return launch<T, 7>(args, n, batch, seq, tiles, s);
    default: return launch<T, 8>(args, n, batch, seq, tiles, s);
  }
}

}  // namespace

// For each of the n inputs i: y[i] (batch, seq, channels[i]) = silu(the
// depthwise causal conv of x[i] (batch, seq, channels[i]) with w[i] (taps,
// channels[i]) + b[i] (channels[i],), or no bias where b[i] is null).  dtype
// of every tensor: 0 = float32, 1 = bfloat16; every pointer 16-byte aligned,
// every tensor contiguous.  Returns a cudaError_t.
extern "C" int repro_causal_conv_silu(const void* const* x, const void* const* w,
                                      const void* const* b, void* const* y,
                                      const long long* channels, int n, int dtype,
                                      long long batch, long long seq, int taps, void* stream) {
  if (n < 1 || n > kMaxInputs || (dtype != 0 && dtype != 1) || taps < 1 || taps > kMaxTaps ||
      batch < 1 || batch > 65535 || seq < 1 || seq > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int per_vec = dtype == 0 ? 4 : 8;
  Inputs args = {};
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (channels[i] < 1 || channels[i] % per_vec || channels[i] / per_vec > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    const void* ptrs[] = {x[i], w[i], b[i], y[i]};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
    if (x[i] == nullptr || w[i] == nullptr || y[i] == nullptr) return cudaErrorInvalidValue;
    const int nv = (int)(channels[i] / per_vec);
    args.in[i] = {static_cast<const uint4*>(x[i]), static_cast<const uint4*>(w[i]),
                  static_cast<const uint4*>(b[i]), static_cast<uint4*>(y[i]), nv, (int)tiles};
    tiles += (nv + kLanes - 1) / kLanes;
  }
  const long long runs = (seq + kWarps * kRows - 1) / (kWarps * kRows);
  if (tiles > 0x7fffffffLL || runs > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_taps<__nv_bfloat16>(args, n, batch, seq, taps, (int)tiles, s);
  return launch_taps<float>(args, n, batch, seq, taps, (int)tiles, s);
}

// The MoE capacity dispatch's row movement for Hopper, sm_90a: a
// slot-indexed gather into the experts' capacity buffers and a token-indexed
// combine of the experts' outputs.
//
// Replaces no Pallas kernel: the JAX package dispatches with XLA's scatter
// and gather (src/repro/models/mlp.py, moe_fwd).  It was added because the
// port's PyTorch expressions for the same dispatch (models/mlp.py, moe_fwd,
// impl="reference") materialise (pair, D) tensors: a zero-filled buffer,
// xf[tok] and index_copy_ for the gather; a cat of the experts' output and
// its overflow row, flat[slot], the weighting product and K - 1 adds over
// strided (T, D) slices for the combine.  At granite_moe_3b's prefill of
// 16 x 2048 tokens (T = 32,768, K = 8, D = 1536, E = 40, C = 8,192) that is
// about 11.5 GB of traffic a layer.
//
// What bounds it: bytes, with no arithmetic to speak of.
//   gather   each of the E_loc C buffer rows written once (zeros for an
//            empty row) and each kept pair's source row read once: 1.76 GB
//            a layer at granite's shape (7% of pairs dropped).
//   combine  each kept pair's expert row read once and y written once: 0.85
//            GB a layer.
// 2.6 GB, about 0.78 ms at 3.35 TB/s.
//
// Design.  A group of G threads (G a power of two up to 32, the smallest
// that covers the row's 16-byte vectors, else 32) owns one row: one buffer
// row in the gather, one token in the combine; a block of 256 threads owns
// 256 / G rows.  Rows move as 16-byte vectors (8 or 4 bytes where the row
// length or an address is not a multiple of 16), neighbouring lanes on
// neighbouring addresses, and each lane issues its loads in batches of
// kBatch before it stores or sums, so that many loads are in flight.  No
// (pair, D) intermediate is formed and no pass fills zeros apart from the
// rows that stay empty.
//
// gather:  out[r] = x[src[r]] where 0 <= src[r] < tokens, else zeros.
//          Bytes are copied: the result is the reference's buffer bit for bit.
// combine: the block loads its tokens' K slot ids and weights once, into
//          shared memory; then, for each of its columns, a token's lane forms
//            c_k = round(e_k * round(w_k * local_k)),  k = 0 .. K-1
//            y   = c_0;  y = round(y + c_k) for k = 1 .. K-1, in that order,
//          round() to the output's type (round to nearest even; identity in
//          float32), e_k the expert row of pair k, or zeros where the pair
//          is dropped or remote: the exact rounding sequence of the
//          reference's `flat[slot] * (w * local)` followed by its chain of
//          adds.  A dropped or remote pair adds its +0.0 in its place in the
//          order, so a -0.0 partial sum turns to +0.0 there, as in the
//          reference.  __fmul_rn and __fadd_rn are never contracted into an
//          FMA.
//
// C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // loads in flight a lane
constexpr int kMaxTopK = 16;

template <int B> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };

// Threads a row: the smallest power of two covering nv vectors, at most 32.
int group_size(long long nv) {
  int g = 1;
  while (g < 32 && g < nv) g *= 2;
  return g;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
moe_gather(const V* __restrict__ x, const int* __restrict__ src, V* __restrict__ out,
           long long rows, long long tokens, int nv, int G) {
  const long long r = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (r >= rows) return;
  const int lane = threadIdx.x % G;
  const int s = src[r];
  V* o = out + r * nv;
  if (s < 0 || s >= tokens) {
    const V z{};
    for (int v = lane; v < nv; v += G) o[v] = z;
    return;
  }
  const V* in = x + (long long)s * nv;
  for (int v0 = lane; v0 < nv; v0 += G * kBatch) {
    V buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = v0 + u * G;
      if (v < nv) buf[u] = __ldg(in + v);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = v0 + u * G;
      if (v < nv) o[v] = buf[u];
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T and back to float.
template <typename T> __device__ __forceinline__ float rounded(float v);
template <> __device__ __forceinline__ float rounded<float>(float v) { return v; }
template <> __device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One token a group of G threads.  Shared memory: the block's tokens' K
// source offsets (in vectors; -1 for a dropped or remote pair) and masked
// weights.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
moe_combine(const V* __restrict__ eout, const long long* __restrict__ slot,
            const T* __restrict__ w, const unsigned char* __restrict__ local,
            V* __restrict__ y, long long tokens, long long rows, int K, int nv, int G) {
  constexpr int E = sizeof(V) / sizeof(T);
  extern __shared__ long long smem[];
  const int R = kThreads / G;
  long long* soff = smem;
  float* sw = reinterpret_cast<float*>(soff + R * K);
  const long long t0 = (long long)blockIdx.x * R;
  const long long left = tokens - t0;
  const int n = (int)(left < R ? left : R) * K;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long p = t0 * K + i;
    const bool mine = local[p] != 0;
    const long long s = slot[p];
    soff[i] = (mine && s >= 0 && s < rows) ? s * nv : -1;
    sw[i] = rounded<T>(__fmul_rn(to_float(w[p]), mine ? 1.f : 0.f));
  }
  __syncthreads();
  const int g = threadIdx.x / G;
  const long long t = t0 + g;
  if (t >= tokens) return;
  const int lane = threadIdx.x % G;
  const long long* off = soff + g * K;
  const float* wk = sw + g * K;
  for (int v = lane; v < nv; v += G) {
    float acc[E];
    for (int k0 = 0; k0 < K; k0 += kBatch) {
      V e[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u;
        e[u] = V{};
        if (k < K && off[k] >= 0) e[u] = __ldg(eout + off[k] + v);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u;
        if (k >= K) break;
        const T* ev = reinterpret_cast<const T*>(&e[u]);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float c = rounded<T>(__fmul_rn(to_float(ev[j]), wk[k]));
          acc[j] = k == 0 ? c : rounded<T>(__fadd_rn(acc[j], c));
        }
      }
    }
    V out;
    T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < E; ++j) ov[j] = from_float<T>(acc[j]);
    y[t * nv + v] = out;
  }
}

template <int B>
int launch_gather(const void* x, const int* src, void* out, long long rows, long long tokens,
                  long long row_bytes, cudaStream_t s) {
  using V = typename VecOf<B>::type;
  const long long nv = row_bytes / B;
  const int G = group_size(nv);
  const long long blocks = (rows + kThreads / G - 1) / (kThreads / G);
  moe_gather<V><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const V*>(x), src, static_cast<V*>(out), rows, tokens, (int)nv, G);
  return cudaGetLastError();
}

template <typename T, int B>
int launch_combine(const void* eout, const long long* slot, const void* w,
                   const unsigned char* local, void* y, long long tokens, long long rows,
                   int K, long long row_bytes, cudaStream_t s) {
  using V = typename VecOf<B>::type;
  const long long nv = row_bytes / B;
  const int G = group_size(nv);
  const int R = kThreads / G;
  const long long blocks = (tokens + R - 1) / R;
  const size_t smem = (size_t)R * K * (sizeof(long long) + sizeof(float));
  moe_combine<T, V><<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const V*>(eout), slot, static_cast<const T*>(w), local,
      static_cast<V*>(y), tokens, rows, K, (int)nv, G);
  return cudaGetLastError();
}

bool valid_vec(int vec_bytes, long long row_bytes, int elem_bytes) {
  return (vec_bytes == 16 || vec_bytes == 8 || vec_bytes == 4) && vec_bytes >= elem_bytes &&
         row_bytes > 0 && row_bytes % vec_bytes == 0 && row_bytes / vec_bytes < (1LL << 30);
}

}  // namespace

// out (rows, row_bytes) = x (tokens, row_bytes) gathered by src (rows,) int32;
// every pointer vec_bytes-aligned.  Returns a cudaError_t.
extern "C" int repro_moe_gather(const void* x, const void* src, void* out, long long rows,
                                long long tokens, long long row_bytes, int vec_bytes,
                                void* stream) {
  if (!valid_vec(vec_bytes, row_bytes, 1) || rows < 0 || tokens < 0 ||
      rows > (long long)0x7fffffff * (kThreads / 32))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(src);
  switch (vec_bytes) {
    case 16: return launch_gather<16>(x, m, out, rows, tokens, row_bytes, s);
    case 8: return launch_gather<8>(x, m, out, rows, tokens, row_bytes, s);
    default: return launch_gather<4>(x, m, out, rows, tokens, row_bytes, s);
  }
}

// y (tokens, D) = the fixed-order combine of eout (rows, D) over slot
// (tokens * K,) int64, w (tokens, K) and local (tokens * K,) bool; dtype of
// eout, w and y: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int repro_moe_combine(const void* eout, const void* slot, const void* w,
                                 const void* local, void* y, int dtype, long long tokens,
                                 long long rows, int K, int D, int vec_bytes, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const long long row_bytes = (long long)D * elem;
  if ((dtype != 0 && dtype != 1) || !valid_vec(vec_bytes, row_bytes, elem) || K < 1 ||
      K > kMaxTopK || tokens < 0 || rows < 0 || tokens > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (tokens == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sl = static_cast<const long long*>(slot);
  const unsigned char* lo = static_cast<const unsigned char*>(local);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    switch (vec_bytes) {
      case 16: return launch_combine<T, 16>(eout, sl, w, lo, y, tokens, rows, K, row_bytes, s);
      case 8: return launch_combine<T, 8>(eout, sl, w, lo, y, tokens, rows, K, row_bytes, s);
      default: return launch_combine<T, 4>(eout, sl, w, lo, y, tokens, rows, K, row_bytes, s);
    }
  }
  switch (vec_bytes) {
    case 16: return launch_combine<float, 16>(eout, sl, w, lo, y, tokens, rows, K, row_bytes, s);
    case 8: return launch_combine<float, 8>(eout, sl, w, lo, y, tokens, rows, K, row_bytes, s);
    default: return launch_combine<float, 4>(eout, sl, w, lo, y, tokens, rows, K, row_bytes, s);
  }
}

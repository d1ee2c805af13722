// Flash attention forward (GQA / MQA / MHA) for Hopper, sm_90a.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel, the Pallas TPU
// kernel, with the same contract: q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D),
// all contiguous; query head h reads KV head h / (Hq / Hkv); online softmax
// with an f32 running max, denominator and accumulator; scale 1/sqrt(D); the
// causal mask is aligned top-left (q_pos >= k_pos, both counted from 0); keys
// at or past Sk are masked; p is rounded to v's dtype before the PV product;
// the output has q's dtype.
//
// What bounds it.  At the serving shape (B=2, Hq=32, Hkv=16, S=1024, D=128,
// bf16, causal) the work is 4*D flops for each of the 33.6 M unmasked
// (q, k) pairs, 17.2 GFLOP, against 50.3 MB that must move (q, k, v read
// once, o written once): 342 flops per byte, above the H100's 295 bf16
// flops per byte of HBM bandwidth, so the bf16 kernel is bound by
// tensor-core operations (17.4 us at 989 TFLOP/s).  hubert_xlarge's prefill
// (B=2, H=16, S=1024, D=80, non-causal) does 10.7 GFLOP against 21.0 MB,
// also bound by operations (10.9 us).  gemma_2b's (B=2, H=16, S=1024, D=256,
// causal) does the same 17.2 GFLOP as the serving shape against 67.1 MB, and
// is bound by bytes (20.0 us).  The f32 path runs on the CUDA cores (no
// tensor cores in full f32) and is bound by their FMA rate.
//
// What the design does about it (bf16, D in {32, 64, 80, 128, 256}): the
// FlashAttention-3 shape.
// - Persistent blocks, one per SM, each with three warpgroups.  Warpgroup 0
//   is the producer: one thread issues TMA loads of a 128-row Q tile and of
//   K and V tiles into a ring of two stages, with a full and an empty
//   mbarrier per stage and tensor (and per Q tile), and runs ahead into the
//   block's next q-tile while the consumers finish the current one.  It
//   gives up registers (setmaxnreg 24) to the two consumer warpgroups
//   (setmaxnreg 240), which own 64 query rows each.
// - Registers: ptxas -v reports 168 a thread, the launch bound's share for
//   384 threads, but that is the count at entry: the consumer branch is
//   compiled within setmaxnreg's 240.  At D=256 a consumer holds O (128 f32
//   registers a thread), S (40) and P (20) for 80-key tiles, 188 in all,
//   with no spill.  What spilled there (1,148 bytes with 64-key tiles, and
//   the wgmmas serialised: ptxas's C7512) was writing O through a staging
//   tile.  A producer of one warp (288 threads, no setmaxnreg) would not
//   help: nine warps put three on one SM sub-partition, whose 16,384
//   registers allow 168 a thread.
// - D=256 (gemma_2b): a 128-row Q tile (64 KB) and two 80-key K/V stages
//   (160 KB) leave no room for an O staging tile (64 KB) either, so each
//   consumer stores its O rows from registers (230,528 B of shared memory).
//   80-key tiles read 4-6% faster than 64-key ones on the small grids (a
//   TP-4 rank's 32 q-tiles, a DP-2 rank's 128) and the same on gemma_2b's
//   prefill, and the two consumers taking turns to issue their products
//   (FA3's ping-pong, on named barriers) read no faster, so they do not
//   (scripts/flash_ab.py).
// - The tensor maps are 3-D over (D, S, B*H), so rows past Sq or Sk come in
//   as zeros and never from the next head.  Tiles are 128-byte swizzled (64
//   columns a box; two boxes for D=128, four for D=256), 64-byte for D=32.
// - D=80 (hubert_xlarge): a row of 160 bytes is no whole number of 128-byte
//   boxes, so the tiles in shared memory are D=128's (two boxes a row) and
//   the maps keep the true extent, 80: TMA fills columns 80-127 of each
//   load with zeros and writes no column past 80 on the store.  S = Q K^T
//   takes the five k16-steps of the 80 true columns and O += P V is one
//   m64n80k16 a k-step (box 0 and the first 16 columns of box 1), so the
//   padded columns are never read; with O at 40 registers a thread the
//   KV tiles are 128 keys (197,760 B of shared memory).  The
//   scale is 1/sqrt(80).
// - S = Q K^T is a wgmma chain with both operands in shared memory, f32
//   accumulators in registers.  P (rounded to bf16 in registers) is the
//   register A operand of the PV wgmma, and V is read as an MN-major B
//   operand straight from its TMA tile: no transposed copy.
// - Each consumer issues S_j = Q K_j^T and then the previous tile's PV
//   product, and runs tile j's softmax (one FFMA and one ex2.approx per
//   score) while the PV product is in flight.  K_j's stage is released as
//   soon as S_j is done, V_j's after its PV product.
// - D=128 takes 64-key tiles (S 32, P 16 and O 64 registers a thread; with
//   128-key tiles it spilled, and ptxas serialised the wgmmas) and D=32, 64,
//   80 take 128-key tiles (S 64, P 32, O up to 40).
// - Causal: KV tiles wholly above the diagonal are never loaded; only the
//   diagonal tiles and the ragged Sk edge are masked.  q-tiles are sorted
//   heaviest first and dealt to the blocks in snake order.
// - O is normalised in registers, written to a staging tile swizzled as the
//   O map expects, and stored by TMA, which clips rows past Sq; at D=256
//   each quad of threads stores 16 contiguous bytes of a row, rows past Sq
//   skipped.
// f32: plain FMA in shared memory with four threads per query row.
//
// C interface for ctypes: returns cudaGetLastError() after the launch.  The
// driver's cuTensorMapEncodeTiled is reached through the runtime's entry
// point query, so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ Hopper primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that never
// ends (a lost arrival) traps after about 2^26 polls, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128-byte, 2 = 64-byte).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// does not move their other uses across the wgmma's issue or wait.
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void pin(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// D (64 x 64, f32) = A B^T (+ D if scale_d): A 64 x 16 and B 64 x 16, both K-major
// in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 80, f32) = A B^T (+ D if scale_d): A 64 x 16 and B 80 x 16, both K-major
// in shared memory.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = A B^T (+ D if scale_d): A 64 x 16 and B 128 x 16, both K-major
// in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A B: A 64 x 16 in registers, B 16 x 32 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A B: A 64 x 16 in registers, B 16 x 64 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A B: A 64 x 16 in registers, B 16 x 80 MN-major in shared memory
// (one 64-column box and the first 16 columns of the next).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A B: A 64 x 16 in registers, B 16 x 128 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A B: A 64 x 16 in registers, B 16 x 256 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(D == 32 || D == 64 || D == 80 || D == 128 || D == 256,
                "no wgmma for this width");
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ------------------------------------------------------------ bf16, wgmma + TMA

constexpr int kStages = 2;
// Registers after setmaxnreg (two consumer warpgroups): the producer keeps
// 24, the consumers share the rest.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Tile {
  // consumer warpgroups per block, 64 query rows each
  static constexpr int CONSUMERS = 2;
  static constexpr int BQ = 64 * CONSUMERS;              // query rows per block
  static constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 loads
  // columns of a tile row in shared memory: D, or D=128's for D=80, whose
  // columns past 80 TMA fills with zeros (and no product reads)
  static constexpr int DT = D == 80 ? 128 : D;
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span: bytes of one box row
  static constexpr int BOX = SW / 2;             // bf16 columns of one box
  static constexpr int NBOX = DT / BOX;
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int BK = D == 256 ? 80 : D >= 128 ? 64 : 128;  // keys per KV tile
  static constexpr int Q_BOX = BQ * SW;           // one box of the Q tile
  static constexpr int Q_BYTES = BQ * DT * 2;
  static constexpr int KV_BOX = BK * SW;          // one box of a K or V tile
  static constexpr int KV_BYTES = BK * DT * 2;
  // O goes out through a staging tile and TMA, but at D = 256, where a Q
  // tile (64 KB), an O tile (64 KB) and two 80-key stages (160 KB) would
  // pass the 232,448 B a block may take: there each consumer stores its O
  // rows from registers, and the block holds no O tile
  static constexpr bool STAGE_O = D != 256;
  // Q and O tiles, the KV stages, 1024 for alignment, 128 for the barriers
  // (D = 256: 64 + 160 KB + 1152 B = 230,528 B)
  static constexpr int SMEM = (STAGE_O ? 2 : 1) * Q_BYTES + 2 * kStages * KV_BYTES + 1024 + 128;
};

// Offset of byte `off` of a swizzled box (1024-byte aligned) as TMA lays it out:
// the 16-byte chunk index is XORed with the row within the 8-row group.
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ ((off >> 3) & (SW == 128 ? 0x70u : 0x30u));
}

// A descriptor that the compiler treats as unknown from here on, so that it
// derives each wgmma's descriptor right before the wgmma instead of keeping
// every one of them in registers across the loop.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// O (64 x D) += P (64 x BK, registers) V (BK x D): `dv` describes the V
// tile as an MN-major B operand; k-step kk advances 16 keys.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&p)[Tile<D>::BK / 16][4], uint64_t dv) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) wgmma_rs<D>(o, p[kk], dv + ((kk * 16 * T::SW) >> 4));
}

// S (64 x BK) = Q K^T over the D true columns: `dq` describes this
// warpgroup's 64 rows of the Q tile, `dk` a K tile (both K-major,
// swizzled); k-step kk advances both.
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[Tile<D>::BK / 2], uint64_t dq,
                                           uint64_t dk) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / T::BOX, col = (kk * 16 % T::BOX) * 2;
    const uint64_t q = dq + ((box * T::Q_BOX + col) >> 4), k = dk + ((box * T::KV_BOX + col) >> 4);
    if constexpr (T::BK == 64) wgmma_ss_n64(s, q, k, kk > 0);
    else if constexpr (T::BK == 80) wgmma_ss_n80(s, q, k, kk > 0);
    else wgmma_ss_n128(s, q, k, kk > 0);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One KV tile's online softmax, in place: s (this thread's part of S for
// rows qpos[0], qpos[1] and keys k0 + 8 nt + 2t (+1)) becomes p.  Updates
// the running max m (in the log2 domain, scaled) and the per-thread partial
// denominators l, and returns each row's correction exp2(m_old - m_new) in
// corr.  Masked scores are set to kNeg before scaling; p = exp2(s * scale -
// m) is one FFMA and one ex2.  The row max and sum run over four partial
// chains each, for instruction-level parallelism.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int Sk, int causal,
                                             bool masked, const int (&qpos)[2], int t,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      if (kpos >= Sk || (causal && qpos[(i >> 1) & 1] < kpos)) s[i] = kNeg;
    }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = kNeg;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float& v = mx[(i >> 1) & 1][(i >> 2) & 3];
    v = fmaxf(v, s[i]);
  }
  float ms[2], rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x * scale_log2);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    ms[r] = m_new;
#pragma unroll
    for (int c = 0; c < 4; ++c) rs[r][c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float e = fast_exp2(fmaf(s[i], scale_log2, -ms[r]));
    s[i] = e;
    rs[r][(i >> 2) & 3] += e;  // the denominator sums p before it is rounded
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
}

// P in bf16, as the A operand's fragments: S's accumulator layout for keys
// 16kk..16kk+15 is the m16n8k16 A layout of those columns.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The q-tile of a block's r-th round: rounds of gridDim.x tiles, walked in
// snake order (forward in even rounds, backward in odd ones) so that with
// tiles sorted heaviest first every block gets about the same work.
__device__ __forceinline__ int tile_of_round(int r) {
  const int base = r * gridDim.x;
  return (r & 1) ? base + gridDim.x - 1 - blockIdx.x : base + blockIdx.x;
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
               int Hq, int Hkv, int Sq, int Sk, int BHq, int n_qt, float scale_log2,
               int causal) {
  using T = Tile<D>;
  constexpr int kConsumers = T::CONSUMERS, kBQ = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q tile
  const uint32_t so = sq + T::Q_BYTES;                      // O tile, staged for TMA
  const uint32_t sk0 = so + (T::STAGE_O ? T::Q_BYTES : 0);  // K stages
  const uint32_t sv0 = sk0 + kStages * T::KV_BYTES;         // V stages
  const uint32_t bars = sv0 + kStages * T::KV_BYTES;
  // barriers: q_full, q_empty, then per stage k_full, k_empty, v_full, v_empty
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + 4 * s); };
  auto k_empty = [&](int s) { return bars + 8 * (3 + 4 * s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + 4 * s); };
  auto v_empty = [&](int s) { return bars + 8 * (5 + 4 * s); };

  // Tile t: q-tile n_qt - 1 - t / BHq (causal: heaviest first) of head t % BHq.
  const int n_t = n_qt * BHq;
  auto q_start = [&](int tile) {
    return (causal ? n_qt - 1 - tile / BHq : tile / BHq) * kBQ;
  };
  auto kv_tiles = [&](int q0) {
    return ((causal ? min(Sk, q0 + kBQ) : Sk) + T::BK - 1) / T::BK;
  };

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);  // lane 0 of each consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kConsumers);
      mbar_init(v_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the Q tile and the KV ring filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid == 0) {
      int it = 0;  // KV tiles loaded so far, over all of this block's q-tiles
      for (int r = 0;; ++r) {
        const int tile = tile_of_round(r);
        if (tile >= n_t) break;
        const int q0 = q_start(tile), bh = tile % BHq;
        const int bkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
        mbar_wait(q_empty, (r & 1) ^ 1);  // a fresh barrier counts as empty
        mbar_expect_tx(q_full, T::Q_BYTES);
        for (int b = 0; b < T::NBOX; ++b)
          tma_load_3d(sq + b * T::Q_BOX, &qmap, q_full, b * T::BOX, q0, bh);
        const int n_kv = kv_tiles(q0);
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), T::KV_BYTES);
          for (int b = 0; b < T::NBOX; ++b)
            tma_load_3d(sk0 + s * T::KV_BYTES + b * T::KV_BOX, &kmap, k_full(s), b * T::BOX,
                        j * T::BK, bkv);
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), T::KV_BYTES);
          for (int b = 0; b < T::NBOX; ++b)
            tma_load_3d(sv0 + s * T::KV_BYTES + b * T::KV_BOX, &vmap, v_full(s), b * T::BOX,
                        j * T::BK, bkv);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows 64w..64w+63 of each q-tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int w = wg - 1;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((tid / 32) & 3) + g;  // this thread's rows of the 64: r0 and r0 + 8
  const uint32_t sq_w = sq + 64 * w * T::SW, so_w = so + 64 * w * T::SW;
  const uint64_t dq = gmma_desc(sq_w, 16, 8 * T::SW, T::LAYOUT);
  auto kdesc = [&](int st) {
    return gmma_desc(sk0 + st * T::KV_BYTES, 16, 8 * T::SW, T::LAYOUT);
  };
  auto vdesc = [&](int st) {
    return gmma_desc(sv0 + st * T::KV_BYTES, T::KV_BOX, 8 * T::SW, T::LAYOUT);
  };

  float o[D / 2];
  float s[T::BK / 2];
  uint32_t p[T::BK / 16][4];
  int it = 0;  // KV tiles consumed so far
  for (int r = 0;; ++r) {
    const int tile = tile_of_round(r);
    if (tile >= n_t) break;
    const int q0 = q_start(tile), bh = tile % BHq, n_kv = kv_tiles(q0);
    const int qpos[2] = {q0 + 64 * w + r0, q0 + 64 * w + r0 + 8};
    // KV tile j needs a mask if it crosses Sk or (causal) holds a key past
    // this warpgroup's first query row
    auto masked = [&](int j) {
      return (j + 1) * T::BK > Sk || (causal && (j + 1) * T::BK - 1 > q0 + 64 * w);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end
    float corr[2];

    mbar_wait(q_full, r & 1);
    // KV tile 0: S_0 and its softmax, with no PV product yet to overlap.
    mbar_wait(k_full(it % kStages), (it / kStages) & 1);
    pin(s);
    wgmma_fence();
    qk_product<D>(s, dq, opaque(kdesc(it % kStages)));
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    if (lane == 0) {
      mbar_arrive(k_empty(it % kStages));
      if (n_kv == 1) mbar_arrive(q_empty);
    }
    softmax_tile<T::BK>(s, m, l, corr, 0, Sk, causal, masked(0), qpos, t, scale_log2);
    pack_p<T::BK>(p, s);
    for (int j = 1; j < n_kv; ++j) {
      // Issue S_j = Q K_j^T, then KV tile j-1's PV product, and run tile j's
      // softmax while the PV product is in flight.
      const int st = (it + j) % kStages, sp = (it + j - 1) % kStages;
      mbar_wait(k_full(st), ((it + j) / kStages) & 1);
      pin(s);
      pin(o);
      pin(p);
      wgmma_fence();
      qk_product<D>(s, dq, opaque(kdesc(st)));
      wgmma_commit();
      mbar_wait(v_full(sp), ((it + j - 1) / kStages) & 1);
      pv_product<D>(o, p, opaque(vdesc(sp)));
      wgmma_commit();
      wgmma_wait<1>();
      pin(s);
      if (lane == 0) {
        mbar_arrive(k_empty(st));
        if (j == n_kv - 1) mbar_arrive(q_empty);  // the last read of this Q tile is done
      }
      softmax_tile<T::BK>(s, m, l, corr, j * T::BK, Sk, causal, masked(j), qpos, t, scale_log2);
      wgmma_wait<0>();
      pin(o);
      if (lane == 0) mbar_arrive(v_empty(sp));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_p<T::BK>(p, s);
    }
    {  // the last KV tile's PV product
      const int sp = (it + n_kv - 1) % kStages;
      mbar_wait(v_full(sp), ((it + n_kv - 1) / kStages) & 1);
      pin(o);
      pin(p);
      wgmma_fence();
      pv_product<D>(o, p, opaque(vdesc(sp)));
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      if (lane == 0) mbar_arrive(v_empty(sp));
    }
    it += n_kv;

    // Normalise O.  D = 256: each thread stores its two rows' pairs of
    // columns straight from registers (a quad writes 16 contiguous bytes of a
    // row), skipping rows past Sq.  Otherwise: write O's D columns to this
    // warpgroup's rows of the O tile, swizzled as the O map expects, once the
    // previous q-tile's store has read them, and store them by TMA.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
    if constexpr (!T::STAGE_O) {
      // no O map here: its first word is O's address (see launch_bf16)
      __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(omap.opaque[0]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (qpos[h] >= Sq) continue;
        uint32_t* row = reinterpret_cast<uint32_t*>(out + ((size_t)bh * Sq + qpos[h]) * D) + t;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          row[4 * dn] = pack_bf16(o[4 * dn + 2 * h] * inv[h], o[4 * dn + 2 * h + 1] * inv[h]);
      }
      continue;
    }
    if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * t;
      const uint32_t box = so + (col / T::BOX) * T::Q_BOX;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = (64 * w + r0 + 8 * h) * T::SW + (col % T::BOX) * 2;
        const uint32_t val =
            pack_bf16(o[4 * dn + 2 * h] * inv[h], o[4 * dn + 2 * h + 1] * inv[h]);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(box + swizzle<T::SW>(off)), "r"(val)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
    if (tid % 128 == 0) {
      for (int b = 0; b < T::NBOX; ++b)
        tma_store_3d(&omap, so_w + b * T::Q_BOX, b * T::BOX, q0 + 64 * w, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (T::STAGE_O && tid % 128 == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ------------------------------------------------------------ f32, FMA

constexpr int kFBQ = 64;  // query rows per block
constexpr int kFBK = 32;  // keys per KV tile
constexpr int kFThreads = 256;  // four threads per query row

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (kFBQ * (D + 1) + kFBK * (D + 1) + kFBK * D + kFBQ * (kFBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int Hq, int Hkv, int Sq, int Sk, float scale_log2, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kFBQ][D + 1]
  float* ks = qs + kFBQ * (D + 1);    // [kFBK][D + 1]
  float* vs = ks + kFBK * (D + 1);    // [kFBK][D]
  float* ps = vs + kFBK * D;          // [kFBQ][kFBK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2, sub = tid & 3;
  const int q0 = blockIdx.x * kFBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const float* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const float* vb = v + (size_t)(b * Hkv + hk) * Sk * D;
  float* ob = o + (size_t)(b * Hq + h) * Sq * D;

  for (int i = tid; i < kFBQ * D; i += kFThreads) {
    const int r = i / D, c = i % D;
    qs[r * (D + 1) + c] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;
  const int qpos = q0 + row;

  const int kv_end = causal ? min(Sk, q0 + kFBQ) : Sk;
  const int n_tiles = (kv_end + kFBK - 1) / kFBK;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kFBK;
    __syncthreads();
    for (int i = tid; i < kFBK * D; i += kFThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      ks[r * (D + 1) + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      vs[r * D + c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float sv[kFBK / 4];
#pragma unroll
    for (int j = 0; j < kFBK / 4; ++j) sv[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kFBK / 4; ++j) sv[j] = fmaf(qv, ks[(sub + 4 * j) * (D + 1) + d], sv[j]);
    }
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kFBK / 4; ++j) {
      const int kpos = k0 + sub + 4 * j;
      const bool ok = kpos < Sk && (!causal || qpos >= kpos);
      sv[j] = ok ? sv[j] * scale_log2 : kNeg;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    m = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kFBK / 4; ++j) {
      const float p = exp2f(sv[j] - m);
      rs += p;
      ps[row * (kFBK + 1) + sub + 4 * j] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * corr + rs;
    __syncwarp();  // the quad's p values are visible to all four threads of the row
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= corr;
    for (int c = 0; c < kFBK; ++c) {
      const float p = ps[row * (kFBK + 1) + c];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = fmaf(p, vs[c * D + sub + 4 * i], acc[i]);
    }
  }
  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) ob[(size_t)qpos * D + sub + 4 * i] = acc[i] * inv;
  }
}


template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                       int Hq, int Hkv, int Sq, int Sk, float scale_log2, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kFBQ - 1) / kFBQ, Hq, B);
  flash_fwd_f32<D><<<grid, kFThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Sk, scale_log2,
      causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------ tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 13000
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#elif CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 (BH, S, D) tensor, read in boxes of
// (box_cols, box_rows, 1) with the given swizzle; out-of-range rows read as
// zeros and are not written.
bool make_map(CUtensorMap* map, const void* ptr, int BH, int S, int D, int box_cols,
              int box_rows, int sw) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                        int Hq, int Hkv, int Sq, int Sk, float scale_log2, int causal,
                        cudaStream_t stream) {
  using T = Tile<D>;
  // Raise the dynamic shared-memory limit once, on the first launch (which
  // happens before any CUDA graph capture that the caller starts).
  static cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (configured != cudaSuccess) return configured;
  CUtensorMap qm, km, vm, om{};
  if (!make_map(&qm, q, B * Hq, Sq, D, T::BOX, T::BQ, T::SW) ||
      !make_map(&km, k, B * Hkv, Sk, D, T::BOX, T::BK, T::SW) ||
      !make_map(&vm, v, B * Hkv, Sk, D, T::BOX, T::BK, T::SW) ||
      (T::STAGE_O && !make_map(&om, o, B * Hq, Sq, D, T::BOX, 64, T::SW)))
    return cudaErrorInvalidValue;
  // Without an O tile there is no O map, and O's address takes its place
  // (an extra kernel parameter made every other D's kernel 1-2% slower).
  if constexpr (!T::STAGE_O) om.opaque[0] = reinterpret_cast<cuuint64_t>(o);
  // Persistent: one block per SM (at most one per q-tile) walks the q-tiles.
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int n_qt = (Sq + T::BQ - 1) / T::BQ;
  const long long tiles = (long long)n_qt * B * Hq;
  if (tiles > 0x7fffffffLL || sms < 1) return cudaErrorInvalidValue;
  flash_fwd_bf16<D><<<(unsigned)(tiles < sms ? tiles : sms), T::THREADS, T::SMEM, stream>>>(
      qm, km, vm, om, Hq, Hkv, Sq, Sk, B * Hq, n_qt, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block of the kernel for dtype and D, in bytes
// (0 if the pair is not supported).
extern "C" int repro_flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == 1) {
    switch (D) {
      case 32: return Tile<32>::SMEM;
      case 64: return Tile<64>::SMEM;
      case 80: return Tile<80>::SMEM;
      case 128: return Tile<128>::SMEM;
      case 256: return Tile<256>::SMEM;
    }
  } else if (dtype == 0) {
    switch (D) {
      case 32: return (int)f32_smem_bytes<32>();
      case 64: return (int)f32_smem_bytes<64>();
      case 80: return (int)f32_smem_bytes<80>();
      case 128: return (int)f32_smem_bytes<128>();
      case 256: return (int)f32_smem_bytes<256>();
    }
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; scale: the softmax scale of the scores
// (1 / sqrt(D) for the usual attention).  Returns a cudaError_t.
extern "C" int repro_flash_attention_fwd_scaled(const void* q, const void* k, const void* v,
                                                void* o, int dtype, int B, int Hq, int Hkv,
                                                int Sq, int Sk, int D, int causal,
                                                double scale, void* stream) {
  const float scale_log2 = (float)(scale * (double)kLog2e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 64: return launch_bf16<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 80: return launch_bf16<80>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 128: return launch_bf16<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 256: return launch_bf16<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 64: return launch_f32<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 80: return launch_f32<80>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 128: return launch_f32<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
      case 256: return launch_f32<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale_log2, causal, s);
    }
  }
  return cudaErrorInvalidValue;
}

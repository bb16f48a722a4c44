// Hopper building blocks of the bfloat16 flash-attention kernels at D = 64
// and D = 128 (flash_attention.cu::flash_fwd_wgmma_kernel,
// flash_attention_bwd.cu::flash_bwd_dkv_wgmma_kernel): warpgroup matrix
// multiplies (wgmma), tile loads by the Tensor Memory Accelerator (TMA) and
// the mbarriers that join them. sm_90a only (wgmma).
//
// * Tiles are loaded by TMA, in boxes of 64 columns (128 bytes of bf16) and
//   up to 256 rows, from a 4-D tensor map (columns, rows, heads, batch) that
//   describes the operand's strided (B, H, T, D) view, so the q, k, v slices
//   of one packed (N, T, heads, 3, D) tensor are read in place. The map
//   swizzles 128 bytes: the 16-byte chunk c of row r lands at chunk
//   c ^ (r % 8) of its row, which keeps wgmma's reads free of bank
//   conflicts. A box is
//   rows x 128 bytes, 1024-byte aligned; a D = 128 tile is two boxes. The map
//   is encoded on the host at every launch (cuTensorMapEncodeTiled, reached
//   through the runtime's driver entry point) and passed by value as a
//   __grid_constant__ kernel parameter.
// * wgmma reads such a tile through a shared-memory descriptor with the same
//   128-byte swizzle: K-major (the reduced dimension along the row: Q, K
//   for S = Q K^T) with 8-row groups 1024 bytes apart, a step of 16 columns
//   adding 32 bytes to the start address; MN-major (V in P V, read
//   transposed), 16 rows a step (2048 bytes), the second 64-column box
//   `lbo` bytes further.
// * The float32 accumulators of m64nNk16 lie in each warp of the warpgroup
//   as the C fragments of mma.sync m16n8 lie (flash_mma.cuh): warp w holds
//   rows 16w..16w+15, register 4j + c column tile j. Two adjacent column
//   tiles of a float32 result are the A fragment of a 16-deep product, so P
//   (and dS) enter the next wgmma from registers as two bf16 terms, hi and
//   lo (flash_mma.cuh, split_bf16x2), without a trip through shared memory.
// * A block is two warpgroups (256 threads: a thread may hold up to 255
//   registers, which the consumers' accumulators need); one of its threads
//   also issues the TMA loads. A warp-specialised block of a producer
//   warpgroup and two consumers (384 threads, setmaxnreg moving registers
//   from the producer to the consumers) spilled at every such
//   instantiation on nvcc 12.9, below the registers setmaxnreg grants, and
//   a 288-thread block (one producer warp) is given 168 registers a
//   thread as the 384-thread one is (PERF.md).
// * A tile's ring stage is `full` once its bytes have landed (one arrival by
//   the loading thread, which set the expected bytes) and `empty` once every
//   warp has waited for the wgmma that read it (one arrival per warp). A
//   wait that has not ended after some 2^35 cycles (seconds) traps: a
//   broken pipeline ends the launch with an error instead of hanging.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace flash_wgmma {

using flash_mma::smem_addr;

constexpr int kBoxCols = 64;        // bf16 columns of one TMA box (128 B)
constexpr int kRowBytes = 128;      // bytes of one box row
constexpr int kThreads = 256;       // two warpgroups
constexpr long long kHangCycles = 1ll << 35;

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - start > kHangCycles) __trap();
}

// ------------------------------------------------------------------ TMA
// One box of a 4-D tensor map (column, row, head, batch) into shared memory;
// completes `bytes` of the barrier's expected transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(col), "r"(row), "r"(head), "r"(batch)
        : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(bar)
        : "memory");
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins accumulator registers in place around the asynchronous wgmma: the
// compiler may not move a read or write of them across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            asm volatile("" : "+f"(d[j][c]) :: "memory");
}

// x, as a value the compiler cannot hoist out of a loop: the descriptors
// built from it are rebuilt in each iteration (a few integer operations)
// instead of being held, 64 bits each, in registers across the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
    asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
    return x;
}

// 2^x by the special function unit, results below 2^-126 flushed to zero
// (probabilities that small add nothing to a float32 sum of at least 1).
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (`lbo`), stride byte offset (`sbo`, 8-row groups), each in
// 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
        | (static_cast<uint64_t>(lbo >> 4) << 16)
        | (static_cast<uint64_t>(sbo >> 4) << 32)
        | (1ull << 62);
}

// K-major operand at `tile` (64-column boxes `box_bytes` apart, 8-row groups
// of 1024 bytes): its 16-column step kk.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int box_bytes,
                                                int kk) {
    return make_desc(tile + (kk >> 2) * box_bytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (read transposed): its 16-row step kk, the next
// 64-column box `box_bytes` further.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int box_bytes,
                                                 int kk) {
    return make_desc(tile + kk * 16 * kRowBytes, box_bytes, 1024);
}

// The A fragments (hi and lo bf16 terms) of 16-deep step kk of a float32
// result held as accumulator tiles x[2 kk], x[2 kk + 1].
template <int R>
__device__ __forceinline__ void split_step(const float (&x)[R][4], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
    flash_mma::split_bf16x2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    flash_mma::split_bf16x2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    flash_mma::split_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    flash_mma::split_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// m64nNk16 bf16 products with float32 accumulators, one warpgroup.
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
    // d = A B^T, A and B K-major in shared memory
    __device__ static void ss_first(float (&d)[8][4], uint64_t desc_a,
                                    uint64_t desc_b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p, 1, 1, 0, 0;\n}\n"
            : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
              "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
              "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
              "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
              "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
              "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]),
              "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
              "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])
            : "l"(desc_a), "l"(desc_b), "r"(0));
    }
    // d += A B^T, A and B K-major in shared memory
    __device__ static void ss(float (&d)[8][4], uint64_t desc_a,
                              uint64_t desc_b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
            : "l"(desc_a), "l"(desc_b), "r"(1));
    }
    // d = A B, A a register fragment, B MN-major in shared memory (read
    // transposed)
    __device__ static void rs_t_first(float (&d)[8][4],
                                      const uint32_t (&a)[4],
                                      uint64_t desc_b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
              "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
              "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
              "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
              "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
              "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]),
              "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
              "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
              "r"(0));
    }
    // d += A B, A a register fragment, B MN-major in shared memory (read
    // transposed)
    __device__ static void rs_t(float (&d)[8][4],
                                const uint32_t (&a)[4], uint64_t desc_b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
              "r"(1));
    }
};

template <> struct Wgmma<128> {
    // d = A B^T, A and B K-major in shared memory
    __device__ static void ss_first(float (&d)[16][4], uint64_t desc_a,
                                    uint64_t desc_b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, 0;\n}\n"
            : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
              "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
              "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
              "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
              "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
              "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]),
              "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
              "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3]),
              "=f"(d[8][0]), "=f"(d[8][1]), "=f"(d[8][2]), "=f"(d[8][3]),
              "=f"(d[9][0]), "=f"(d[9][1]), "=f"(d[9][2]), "=f"(d[9][3]),
              "=f"(d[10][0]), "=f"(d[10][1]), "=f"(d[10][2]), "=f"(d[10][3]),
              "=f"(d[11][0]), "=f"(d[11][1]), "=f"(d[11][2]), "=f"(d[11][3]),
              "=f"(d[12][0]), "=f"(d[12][1]), "=f"(d[12][2]), "=f"(d[12][3]),
              "=f"(d[13][0]), "=f"(d[13][1]), "=f"(d[13][2]), "=f"(d[13][3]),
              "=f"(d[14][0]), "=f"(d[14][1]), "=f"(d[14][2]), "=f"(d[14][3]),
              "=f"(d[15][0]), "=f"(d[15][1]), "=f"(d[15][2]), "=f"(d[15][3])
            : "l"(desc_a), "l"(desc_b), "r"(0));
    }
    // d += A B^T, A and B K-major in shared memory
    __device__ static void ss(float (&d)[16][4], uint64_t desc_a,
                              uint64_t desc_b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
              "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
              "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
              "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
              "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
              "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
              "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
              "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
              "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
            : "l"(desc_a), "l"(desc_b), "r"(1));
    }
};

// ------------------------------------------------------------------ host
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (the build
// links no libcuda).
inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
    return fn;
}

// The tensor map of a bf16 (B, H, T, D) view with element strides sb, sh, st
// (the last dimension contiguous), boxes of 64 columns x `rows` rows, 128-byte
// swizzle.
inline cudaError_t encode_operand(CUtensorMap* map, const void* ptr, int batch,
                                  int heads, int t, int d, long long sb,
                                  long long sh, long long st, int rows) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(t),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                   static_cast<cuuint64_t>(sh) * 2,
                                   static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The first 1024-byte aligned byte of dynamic shared memory (the layouts
// reserve 1024 bytes for this).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
    return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

}  // namespace flash_wgmma

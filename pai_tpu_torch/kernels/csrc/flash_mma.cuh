// Warp-level tensor-core building blocks of the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) for Hopper (sm_90a). At D =
// 64 and 128 the forward, dq and dkv in bfloat16, and the forward and dkv
// in float32, run on warpgroup wgmma instead (flash_wgmma.cuh), and take
// split_bf16x2, split_tf32, store_rows and kPnKeys from here.
//
// Every product is an `mma.sync` of one warp over 16 rows:
//
// * bfloat16 operands: m16n8k16 with bf16 inputs and a float32 accumulator.
//   Q, K, V and dO are exact in bf16, so their products take one mma. The
//   float32 probabilities P (and dS) enter their product as two bf16 terms,
//   hi = bf16(p) and lo = bf16(p - hi): two mmas, so the product keeps the
//   precision of float32 P that the reference keeps.
// * float32 operands: m16n8k8 with TF32 inputs, three terms (3xTF32): each
//   value x is split as hi = x rounded to TF32 (to nearest even) and
//   lo = x - hi (which the tensor core truncates to TF32), and a product
//   is lo*hi + hi*lo + hi*hi (lo*lo dropped), float32 accumulate: float32
//   accuracy on the tensor cores, never TF32 alone.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k*"), g = lane/4,
// t = lane%4:
//   bf16 A (16x16): {a0, a1, a2, a3} = rows {g, g+8, g, g+8}, columns
//       {2t, 2t+1} (a0, a1) and {2t+8, 2t+9} (a2, a3), two per register.
//   bf16 B (16x8):  b0 = rows 2t, 2t+1 of column g; b1 = rows 2t+8, 2t+9.
//   tf32 A (16x8):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
//   tf32 B (8x8):   b0 (t, g), b1 (t+4, g).
//   C (16x8 f32):   c0, c1 (g, 2t), (g, 2t+1); c2, c3 (g+8, 2t), (g+8, 2t+1).
// Two adjacent bf16 C tiles are one bf16 A fragment. A tf32 A fragment holds
// columns t and t+4 where the C fragment holds 2t and 2t+1, so when P (a C
// fragment) becomes an A operand, its k slot t carries key 2t and slot t+4
// key 2t+1; the B operand's rows are loaded in the same permuted order (a sum
// over k does not depend on the order of its terms).
//
// Shared-memory rows are padded so that fragment loads hit distinct banks:
// bf16 rows of D + 8 elements (an odd number of 16-byte units: ldmatrix's
// eight row addresses of a phase fall in eight distinct 16-byte bank groups);
// float32 rows of D + 4 (4 mod 32 words: the 32-bit loads of (g, t) hit bank
// 4g + t, those of rows 2t, 2t+1 at column g banks 8t + g and 8t + 4 + g).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

constexpr float kLog2e = 1.44269504088896340736f;
constexpr float kLn2 = 0.69314718055994530942f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(smem_dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo + (what 3xTF32 drops). hi is x rounded to TF32, to nearest
// even: cvt.rn.tf32.f32 is one F2FP instruction on sm_90, where
// cvt.rna.tf32.f32 (ties away from zero) compiles to several with guards for
// non-finite inputs, and the split is most of the float32 kernels' work
// besides the mma itself. lo = x - hi goes to the tensor core as it is,
// which reads its top 19 bits (truncation); a NaN or an infinity in x leaves
// a NaN in lo, so it still reaches the result.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Two adjacent float32 values as two packed bf16 terms: x = hi + lo + O(2^-16 x).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, starting from a zero accumulator.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
}

__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
}

// The three terms of one 3xTF32 product, small ones first (a fixed order:
// the result does not depend on timing); `fresh` starts c from zero.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo,
                                           bool fresh = false) {
    if (fresh)
        mma_tf32_zero(c, a_lo, b0_hi, b1_hi);
    else
        mma_tf32(c, a_lo, b0_hi, b1_hi);
    mma_tf32(c, a_hi, b0_lo, b1_lo);
    mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// The tensor cores add an mma's products into its accumulator with
// truncation (toward zero), so an accumulator carried across a long sum over
// k drifts by about one float32 unit per mma, all in one direction: over the
// 16,384 keys of P V that is some 10^-4 of the result. The products that sum
// over the keys (gemm_pn) therefore collect at most kPnKeys keys in a fresh
// accumulator and add it to the running sum with an ordinary float32 add,
// which rounds to nearest.
constexpr int kPnKeys = 32;

// Per element type: shared-memory row padding and the two products a warp
// runs over its 16 rows.
template <typename T> struct Warp;

// ---------------------------------------------------------------- bfloat16
template <> struct Warp<__nv_bfloat16> {
    using Elem = __nv_bfloat16;
    static constexpr int kPad = 8;     // elements per row beyond D
    static constexpr int kVec = 8;     // elements per 16-byte copy

    // acc[j] += A B_j^T over K columns: A is the warp's 16 rows at `a`
    // (row stride S), B_j rows 8j..8j+7 at `b` (S = Q K^T, S^T = K Q^T,
    // dP^T = V dO^T). One mma per 16 columns and 8 outputs.
    template <int NTILES, int K, int S>
    __device__ static void gemm_nt(float (&acc)[NTILES][4], const Elem* a,
                                   const Elem* b, int lane) {
        static_assert(NTILES % 2 == 0 && K % 16 == 0, "tile shape");
        const int r8 = lane & 7;
        const int m = lane >> 3;
#pragma unroll
        for (int c = 0; c < K / 16; ++c) {
            uint32_t af[4];
            ldmatrix_x4(af, a + (r8 + 8 * (m & 1)) * S + 16 * c + 8 * (m >> 1));
#pragma unroll
            for (int j = 0; j < NTILES; j += 2) {
                uint32_t bf[4];
                ldmatrix_x4(bf, b + (8 * j + r8 + 8 * (m >> 1)) * S + 16 * c
                            + 8 * (m & 1));
                mma_bf16(acc[j], af, bf[0], bf[1]);
                mma_bf16(acc[j + 1], af, bf[2], bf[3]);
            }
        }
    }

    // acc[i] += P M[:, 8i..8i+7]: P the warp's 16 x (8 KTILES) float32
    // probabilities in C fragments, M row-major at `b` (row stride S).
    // P = hi + lo in bf16, two mmas per term; partial sums of kPnKeys keys.
    template <int KTILES, int NTILES, int S>
    __device__ static void gemm_pn(float (&acc)[NTILES][4],
                                   const float (&p)[KTILES][4], const Elem* b,
                                   int lane) {
        static_assert(NTILES % 2 == 0 && KTILES % 2 == 0, "tile shape");
        constexpr int G = (KTILES * 8 >= kPnKeys) ? kPnKeys / 16 : KTILES / 2;
        static_assert((KTILES / 2) % G == 0, "tile shape");
        const int r8 = lane & 7;
        const int m = lane >> 3;
#pragma unroll
        for (int k0 = 0; k0 < KTILES / 2; k0 += G) {
            uint32_t hi[G][4], lo[G][4];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int kk = k0 + g;
                split_bf16x2(p[2 * kk][0], p[2 * kk][1], hi[g][0], lo[g][0]);
                split_bf16x2(p[2 * kk][2], p[2 * kk][3], hi[g][1], lo[g][1]);
                split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[g][2],
                             lo[g][2]);
                split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[g][3],
                             lo[g][3]);
            }
#pragma unroll
            for (int i = 0; i < NTILES; i += 2) {
                float part[2][4];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    uint32_t bf[4];
                    ldmatrix_x4_trans(bf, b + (16 * (k0 + g) + r8
                                               + 8 * (m & 1)) * S
                                      + 8 * i + 8 * (m >> 1));
                    if (g == 0) {
                        mma_bf16_zero(part[0], lo[g], bf[0], bf[1]);
                        mma_bf16_zero(part[1], lo[g], bf[2], bf[3]);
                    } else {
                        mma_bf16(part[0], lo[g], bf[0], bf[1]);
                        mma_bf16(part[1], lo[g], bf[2], bf[3]);
                    }
                    mma_bf16(part[0], hi[g], bf[0], bf[1]);
                    mma_bf16(part[1], hi[g], bf[2], bf[3]);
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    acc[i][c] += part[0][c];
                    acc[i + 1][c] += part[1][c];
                }
            }
        }
    }
};

// ----------------------------------------------------------------- float32
template <> struct Warp<float> {
    using Elem = float;
    static constexpr int kPad = 4;
    static constexpr int kVec = 4;

    template <int NTILES, int K, int S>
    __device__ static void gemm_nt(float (&acc)[NTILES][4], const Elem* a,
                                   const Elem* b, int lane) {
        static_assert(K % 8 == 0, "tile shape");
        const int g = lane >> 2;
        const int t = lane & 3;
#pragma unroll
        for (int c = 0; c < K / 8; ++c) {
            uint32_t a_hi[4], a_lo[4];
            const Elem* ap = a + g * S + 8 * c + t;
            split_tf32(ap[0], a_hi[0], a_lo[0]);
            split_tf32(ap[8 * S], a_hi[1], a_lo[1]);
            split_tf32(ap[4], a_hi[2], a_lo[2]);
            split_tf32(ap[8 * S + 4], a_hi[3], a_lo[3]);
#pragma unroll
            for (int j = 0; j < NTILES; ++j) {
                const Elem* bp = b + (8 * j + g) * S + 8 * c + t;
                uint32_t b0h, b0l, b1h, b1l;
                split_tf32(bp[0], b0h, b0l);
                split_tf32(bp[4], b1h, b1l);
                mma_3xtf32(acc[j], a_hi, a_lo, b0h, b1h, b0l, b1l);
            }
        }
    }

    // k slot t of chunk kk carries row 8kk + 2t of M, slot t + 4 row
    // 8kk + 2t + 1: the order in which P's C fragment holds its columns.
    // Partial sums of kPnKeys keys (or of the whole tile if shorter).
    template <int KTILES, int NTILES, int S>
    __device__ static void gemm_pn(float (&acc)[NTILES][4],
                                   const float (&p)[KTILES][4], const Elem* b,
                                   int lane) {
        constexpr int G = (KTILES * 8 >= kPnKeys) ? kPnKeys / 8 : KTILES;
        static_assert(KTILES % G == 0, "tile shape");
        const int g8 = lane >> 2;
        const int t = lane & 3;
#pragma unroll
        for (int k0 = 0; k0 < KTILES; k0 += G) {
            uint32_t a_hi[G][4], a_lo[G][4];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                split_tf32(p[k0 + g][0], a_hi[g][0], a_lo[g][0]);
                split_tf32(p[k0 + g][2], a_hi[g][1], a_lo[g][1]);
                split_tf32(p[k0 + g][1], a_hi[g][2], a_lo[g][2]);
                split_tf32(p[k0 + g][3], a_hi[g][3], a_lo[g][3]);
            }
#pragma unroll
            for (int i = 0; i < NTILES; ++i) {
                float part[4];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const Elem* bp = b + (8 * (k0 + g) + 2 * t) * S + g8
                        + 8 * i;
                    uint32_t b0h, b0l, b1h, b1l;
                    split_tf32(bp[0], b0h, b0l);
                    split_tf32(bp[S], b1h, b1l);
                    mma_3xtf32(part, a_hi[g], a_lo[g], b0h, b1h, b0l, b1l,
                               g == 0);
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][c] += part[c];
            }
        }
    }
};

// Copies ROWS x COLS elements (global row stride `row_stride` elements, last
// dimension contiguous) into shared memory rows of S elements by cp.async,
// 16 bytes per thread and step; the caller commits and waits.
template <typename T, int ROWS, int COLS, int S, int NT>
__device__ __forceinline__ void copy_tile(T* smem, const T* gmem,
                                          long long row_stride, int tid) {
    constexpr int kVec = Warp<T>::kVec;
    constexpr int kPerRow = COLS / kVec;
#pragma unroll
    for (int idx = tid; idx < ROWS * kPerRow; idx += NT) {
        const int r = idx / kPerRow;
        const int c = (idx % kPerRow) * kVec;
        cp_async_16(smem + r * S + c, gmem + r * row_stride + c);
    }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Writes a warp's 16 x (8 NTILES) C-fragment accumulator to rows g (times
// scale0) and g + 8 (times scale1) of `out` (row stride in elements).
template <typename T, int NTILES>
__device__ __forceinline__ void store_rows(T* out, long long row_stride,
                                           const float (&acc)[NTILES][4],
                                           float scale0, float scale1,
                                           int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
    T* r0 = out + g * row_stride + 2 * t;
    T* r1 = r0 + 8 * row_stride;
#pragma unroll
    for (int i = 0; i < NTILES; ++i) {
        store_pair(r0 + 8 * i, acc[i][0] * scale0, acc[i][1] * scale0);
        store_pair(r1 + 8 * i, acc[i][2] * scale1, acc[i][3] * scale1);
    }
}

}  // namespace flash_mma

// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the two TPU kernels of pai_tpu/kernels/flash_attention.py's
// _flash_backward: _bwd_dq_kernel (pallas_call at :290) and _bwd_dkv_kernel
// (pallas_call at :316). Non-causal, unmasked attention over (B, H, T, D) with
// QKVAttentionLegacy scaling, s^2 = D^-1/2. Given the forward's per-row
// log-sum-exp `lse` and delta = rowsum(dO * O) (both (B*H, T) float32, made
// outside the kernels, as the JAX package makes delta in XLA):
//
//     P  = exp(s^2 Q K^T - lse)          (recomputed, never stored)
//     dS = P * (dO V^T - delta)
//     dQ = s^2 dS K                      flash_bwd_dq_kernel
//     dV = P^T dO,  dK = s^2 dS^T Q      flash_bwd_dkv_kernel
//
// Operands are float or bfloat16; P and dS are float32 and every sum is
// float32; the outputs are written in the operands' type.
//
// What bounds them on an H100: operations. dq does three products of
// 2*T^2*D per head (6*B*H*T^2*D), dkv four (8*B*H*T^2*D), against some
// 8*B*H*T*D elements moved.
//
// * Each output tile has exactly one writer, as on the TPU: dq's block owns
//   one (batch*head, 64-row query tile) and loops over the K/V tiles; dkv's
//   block owns one (batch*head, key tile) and loops over the query tiles.
//   No atomics, so the result is bit-reproducible, and lse and delta are
//   inputs, never recomputed inside: a caller may pass a global lse that
//   spans more keys than the ones it hands over (ring attention's hops).
// * dkv runs on the tensor cores (flash_mma.cuh; its design is described
//   above the kernel below), in the transposed frame S^T = K Q^T.
// * dq still runs float32 FMAs on the CUDA cores (bfloat16 operands are
//   converted as they are loaded; the 67 TFLOP/s of the CUDA cores bound
//   it). 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i
//   and columns tx + 16 j of every T x T tile, and rows ty + 16 i, columns
//   (16 j + tx) * VW + c of its D-wide accumulator, which stays in registers
//   from the first tile to the last. S and dP of a tile run in one loop over
//   D (each 16-byte load of an operand row feeds two FMA chains); rows are
//   padded (D + 4 floats; dS rows BK + 16) so that the 16-byte loads of a
//   quarter-warp fall into distinct banks; Q is pre-multiplied by
//   s^2 * log2(e), lse is taken to log2 units and the exponential is exp2f;
//   float K/V tiles arrive by cp.async, one stage (ROADMAP.md Queue D).
//
// Dynamic shared memory (up to 211,968 bytes), so each instantiation is given
// cudaFuncAttributeMaxDynamicSharedMemorySize before its launch. Plain C
// interface; each entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::Warp;

constexpr int kThreads = 256;
constexpr float kLog2e = 1.44269504088896340736f;

struct BwdParams {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;    // (B*H, T), natural log
    const float* delta;  // (B*H, T)
    void* dq;
    void* dk;
    void* dv;
    int heads;
    int t;
    long long q_sb, q_sh, q_st;
    long long k_sb, k_sh, k_st;
    long long v_sb, v_sh, v_st;
    long long do_sb, do_sh, do_st;
    long long dq_sb, dq_sh, dq_st;
    long long dk_sb, dk_sh, dk_st;
    long long dv_sb, dv_sh, dv_st;
    float logit_scale;  // D^-1/2 * log2(e)
    float grad_scale;   // D^-1/2
};

template <typename T> struct Elem;

template <> struct Elem<float> {
    static constexpr bool kAsync = true;
    __device__ static float4 load4(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
    __device__ static void store4(float* p, float4 x) {
        *reinterpret_cast<float4*>(p) = x;
    }
    __device__ static void store2(float* p, float x, float y) {
        *reinterpret_cast<float2*>(p) = make_float2(x, y);
    }
};

template <> struct Elem<__nv_bfloat16> {
    static constexpr bool kAsync = false;
    __device__ static float4 load4(const __nv_bfloat16* p) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        const float2 a = __bfloat1622float2(lo);
        const float2 b = __bfloat1622float2(hi);
        return make_float4(a.x, a.y, b.x, b.y);
    }
    __device__ static void store4(__nv_bfloat16* p, float4 x) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
        uint2 raw;
        raw.x = *reinterpret_cast<unsigned int*>(&lo);
        raw.y = *reinterpret_cast<unsigned int*>(&hi);
        *reinterpret_cast<uint2*>(p) = raw;
    }
    __device__ static void store2(__nv_bfloat16* p, float x, float y) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    }
};

__device__ __forceinline__ void cp_async_16(float* smem_dst, const float* src) {
    const unsigned int dst =
        static_cast<unsigned int>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies ROWS x D elements (row stride `row_stride` elements) into shared
// memory as floats (row stride SMEM_STRIDE floats), 4 elements per thread and
// step, coalesced along D. Float operands go by cp.async (the caller waits).
template <typename T, int D, int ROWS, int SMEM_STRIDE>
__device__ __forceinline__ void load_tile(float* smem, const T* gmem,
                                          long long row_stride, int tid) {
    constexpr int kVecPerRow = D / 4;
    constexpr int kVecs = ROWS * kVecPerRow;
    static_assert(kVecs % kThreads == 0, "tile must divide over the block");
#pragma unroll
    for (int it = 0; it < kVecs / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int r = idx / kVecPerRow;
        const int c = (idx % kVecPerRow) * 4;
        const T* src = gmem + r * row_stride + c;
        float* dst = smem + r * SMEM_STRIDE + c;
        if constexpr (Elem<T>::kAsync) {
            cp_async_16(dst, src);
        } else {
            *reinterpret_cast<float4*>(dst) = Elem<T>::load4(src);
        }
    }
}

// The same copy, multiplied by `scale` on the way (synchronous).
template <typename T, int D, int ROWS, int SMEM_STRIDE>
__device__ __forceinline__ void load_tile_scaled(float* smem, const T* gmem,
                                                 long long row_stride, int tid,
                                                 float scale) {
    constexpr int kVecPerRow = D / 4;
    constexpr int kVecs = ROWS * kVecPerRow;
    static_assert(kVecs % kThreads == 0, "tile must divide over the block");
#pragma unroll
    for (int it = 0; it < kVecs / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int r = idx / kVecPerRow;
        const int c = (idx % kVecPerRow) * 4;
        float4 x = Elem<T>::load4(gmem + r * row_stride + c);
        x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
        *reinterpret_cast<float4*>(smem + r * SMEM_STRIDE + c) = x;
    }
}

// Two products over D at once, rows ty + 16 i of (a, b) against rows
// tx + 16 j of (c, e):  x[i][j] += a_i . c_j,  y[i][j] += b_i . e_j.
template <int D, int RR, int CC, int S>
__device__ __forceinline__ void dual_dot(const float* a, const float* b,
                                         const float* c, const float* e,
                                         int ty, int tx, float (&x)[RR][CC],
                                         float (&y)[RR][CC]) {
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int j = 0; j < CC; ++j) { x[i][j] = 0.0f; y[i][j] = 0.0f; }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
        float4 cf[CC], ef[CC];
#pragma unroll
        for (int j = 0; j < CC; ++j) {
            cf[j] = *reinterpret_cast<const float4*>(c + (tx + 16 * j) * S + d);
            ef[j] = *reinterpret_cast<const float4*>(e + (tx + 16 * j) * S + d);
        }
#pragma unroll
        for (int i = 0; i < RR; ++i) {
            const float4 af =
                *reinterpret_cast<const float4*>(a + (ty + 16 * i) * S + d);
            const float4 bf =
                *reinterpret_cast<const float4*>(b + (ty + 16 * i) * S + d);
#pragma unroll
            for (int j = 0; j < CC; ++j) {
                x[i][j] = fmaf(af.x, cf[j].x, x[i][j]);
                x[i][j] = fmaf(af.y, cf[j].y, x[i][j]);
                x[i][j] = fmaf(af.z, cf[j].z, x[i][j]);
                x[i][j] = fmaf(af.w, cf[j].w, x[i][j]);
                y[i][j] = fmaf(bf.x, ef[j].x, y[i][j]);
                y[i][j] = fmaf(bf.y, ef[j].y, y[i][j]);
                y[i][j] = fmaf(bf.z, ef[j].z, y[i][j]);
                y[i][j] = fmaf(bf.w, ef[j].w, y[i][j]);
            }
        }
    }
}

// Reads VW consecutive floats at p into out.
template <int VW>
__device__ __forceinline__ void read_vec(const float* p, float (&out)[VW]) {
    if constexpr (VW == 4) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    } else {
        const float2 x = *reinterpret_cast<const float2*>(p);
        out[0] = x.x; out[1] = x.y;
    }
}

// Writes the (RR x NV x VW) accumulator of rows ty + 16 i, times `scale`.
template <typename T, int RR, int NV, int VW>
__device__ __forceinline__ void store_rows(T* g, long long row_stride, int ty,
                                           int tx, float scale,
                                           const float (&acc)[RR][NV][VW]) {
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            T* dst = g + (ty + 16 * i) * row_stride + (16 * j + tx) * VW;
            if constexpr (VW == 4) {
                Elem<T>::store4(dst, make_float4(
                    acc[i][j][0] * scale, acc[i][j][1] * scale,
                    acc[i][j][2] * scale, acc[i][j][3] * scale));
            } else {
                Elem<T>::store2(dst, acc[i][j][0] * scale,
                                acc[i][j][1] * scale);
            }
        }
}

// ------------------------------------------------------------------- dQ
template <int D, int BQ, int BK> struct DqLayout {
    static constexpr int kStride = D + 4;
    static constexpr int kDsStride = BK + 16;
    static constexpr int kQ = 0;
    static constexpr int kDo = kQ + BQ * kStride;
    static constexpr int kK = kDo + BQ * kStride;
    static constexpr int kV = kK + BK * kStride;
    static constexpr int kDs = kV + BK * kStride;
    static constexpr int kFloats = kDs + BQ * kDsStride;
    static constexpr int kBytes = kFloats * 4;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, (D <= 64 ? 2 : 1))
flash_bwd_dq_kernel(const BwdParams p) {
    using L = DqLayout<D, BQ, BK>;
    constexpr int RQ = BQ / 16;            // query rows per thread
    constexpr int CK = BK / 16;            // key columns per thread
    constexpr int VW = (D >= 64) ? 4 : 2;  // output columns per vector
    constexpr int NV = D / 16 / VW;        // output vectors per thread
    constexpr int S = L::kStride;
    constexpr int DS = L::kDsStride;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* smem = reinterpret_cast<float*>(smem_raw);
    float* q_s = smem + L::kQ;
    float* do_s = smem + L::kDo;
    float* k_s = smem + L::kK;
    float* v_s = smem + L::kV;
    float* ds_s = smem + L::kDs;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int q0 = blockIdx.x * BQ;

    const T* q_g = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
        + static_cast<long long>(q0) * p.q_st;
    const T* do_g = static_cast<const T*>(p.dout) + b * p.do_sb
        + h * p.do_sh + static_cast<long long>(q0) * p.do_st;
    const T* k_g = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v_g = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

    load_tile<T, D, BQ, S>(do_s, do_g, p.do_st, tid);
    load_tile_scaled<T, D, BQ, S>(q_s, q_g, p.q_st, tid, p.logit_scale);

    float lse2[RQ], dlt[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const long long row = static_cast<long long>(bh) * p.t + q0 + ty
            + 16 * i;
        lse2[i] = p.lse[row] * kLog2e;
        dlt[i] = p.delta[row];
    }

    float acc[RQ][NV][VW];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
            for (int c = 0; c < VW; ++c) acc[i][j][c] = 0.0f;

    const int n_tiles = p.t / BK;
    for (int tile = 0; tile < n_tiles; ++tile) {
        __syncthreads();  // everyone is done with K, V and dS of the last tile
        const long long k0 = static_cast<long long>(tile) * BK;
        load_tile<T, D, BK, S>(k_s, k_g + k0 * p.k_st, p.k_st, tid);
        load_tile<T, D, BK, S>(v_s, v_g + k0 * p.v_st, p.v_st, tid);
        cp_async_wait_all();
        __syncthreads();

        // S = Q K^T (log2 units) and dP = dO V^T
        float s[RQ][CK], dp[RQ][CK];
        dual_dot<D, RQ, CK, S>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                const float pv = exp2f(s[i][j] - lse2[i]);
                ds_s[(ty + 16 * i) * DS + tx + 16 * j] = pv * (dp[i][j] - dlt[i]);
            }
        __syncthreads();

        // dQ += dS K, columns (16 j + tx) * VW + c
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float dsr[RQ][4];
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const float4 x = *reinterpret_cast<const float4*>(
                    ds_s + (ty + 16 * i) * DS + kk);
                dsr[i][0] = x.x; dsr[i][1] = x.y; dsr[i][2] = x.z; dsr[i][3] = x.w;
            }
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                float kv[4][VW];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    read_vec<VW>(k_s + (kk + r) * S + (16 * j + tx) * VW, kv[r]);
#pragma unroll
                for (int i = 0; i < RQ; ++i)
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < VW; ++c)
                            acc[i][j][c] = fmaf(dsr[i][r], kv[r][c], acc[i][j][c]);
            }
        }
    }

    T* dq_g = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh
        + static_cast<long long>(q0) * p.dq_st;
    store_rows<T, RQ, NV, VW>(dq_g, p.dq_st, ty, tx, p.grad_scale, acc);
}

// ------------------------------------------------------------------ dK, dV
// On the tensor cores (flash_mma.cuh): bf16 m16n8k16 for bfloat16 operands
// (P^T and dS^T as two bf16 terms each), 3xTF32 m16n8k8 for float32 ones.
// One block owns BK keys of one batch*head (and DO of the D output columns)
// and loops over BQ-row query tiles; each of its BK/16 warps owns 16 keys.
// All four products read their A operand from the warp's own rows:
//     S^T = K Q^T,  dP^T = V dO^T    (A: K, V rows in shared memory, fixed
//                                     for the whole loop; B: the Q, dO tile)
//     dV += P^T dO,  dK += dS^T Q    (A: P^T, dS^T straight from the
//                                     accumulator fragments, in registers)
// K and V stay in shared memory and their fragments are loaded per tile, not
// held in registers: held, they would take D/2 (bf16) or 2D (TF32 hi and lo)
// registers a thread beside dK and dV (D), S^T and dP^T (BQ), where the
// kernel already uses 228-255 of 255. Q, dO, lse and delta arrive by cp.async
// in a ring of two stages; K and V are copied once. float32 fragments are
// split into TF32 hi/lo as they are loaded, as in the forward
// (flash_attention.cu says why). Where the dK and dV accumulators of 16 keys
// would not fit in a thread's registers (D = 256: 256 of them), the grid's z
// axis splits the output columns into halves of DO (S^T and dP^T, which
// reduce over all of D, are computed by both).
template <typename T, int D, int BK, int BQ> struct DkvLayout {
    static constexpr int kStride = D + Warp<T>::kPad;  // elements per row
    static constexpr int kK = 0;
    static constexpr int kV = kK + BK * kStride;
    static constexpr int kQ = kV + BK * kStride;        // 2 stages
    static constexpr int kDo = kQ + 2 * BQ * kStride;   // 2 stages
    static constexpr int kElems = kDo + 2 * BQ * kStride;
    // then float32 lse and delta, 2 stages each
    static constexpr int kStats = kElems * static_cast<int>(sizeof(T));
    static constexpr int kBytes = kStats + 4 * BQ * 4;
};

template <typename T, int D, int DO, int BK, int BQ>
__global__ void __launch_bounds__(2 * BK, 1)
flash_bwd_dkv_kernel(const BwdParams p) {
    using L = DkvLayout<T, D, BK, BQ>;
    using W = Warp<T>;
    constexpr int NT = 2 * BK;       // threads: BK / 16 warps
    constexpr int S = L::kStride;
    constexpr int QT = BQ / 8;       // 8-column tiles of S^T (queries)
    constexpr int OT = DO / 8;       // 8-column tiles of dK and dV
    constexpr int kStatVecs = BQ / 4;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    float* stats = reinterpret_cast<float*>(smem_raw + L::kStats);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bh = blockIdx.y;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int k0 = blockIdx.x * BK;
    const int col0 = blockIdx.z * DO;

    const T* k_g = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh
        + static_cast<long long>(k0) * p.k_st;
    const T* v_g = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh
        + static_cast<long long>(k0) * p.v_st;
    const T* q_g = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* do_g = static_cast<const T*>(p.dout) + b * p.do_sb
        + h * p.do_sh;
    const float* lse_g = p.lse + static_cast<long long>(bh) * p.t;
    const float* dl_g = p.delta + static_cast<long long>(bh) * p.t;

    // Q, dO, lse and delta of query tile `tile` into ring stage `stage`.
    auto copy_stage = [&](int tile, int stage) {
        const long long q0 = static_cast<long long>(tile) * BQ;
        flash_mma::copy_tile<T, BQ, D, S, NT>(
            smem + L::kQ + stage * BQ * S, q_g + q0 * p.q_st, p.q_st, tid);
        flash_mma::copy_tile<T, BQ, D, S, NT>(
            smem + L::kDo + stage * BQ * S, do_g + q0 * p.do_st, p.do_st, tid);
        for (int idx = tid; idx < 2 * kStatVecs; idx += NT) {
            const int which = idx / kStatVecs;  // 0 lse, 1 delta
            const int i4 = (idx % kStatVecs) * 4;
            flash_mma::cp_async_16(stats + (2 * stage + which) * BQ + i4,
                                   (which ? dl_g : lse_g) + q0 + i4);
        }
        flash_mma::cp_async_commit();
    };

    flash_mma::copy_tile<T, BK, D, S, NT>(smem + L::kK, k_g, p.k_st, tid);
    flash_mma::copy_tile<T, BK, D, S, NT>(smem + L::kV, v_g, p.v_st, tid);
    copy_stage(0, 0);  // one group with K and V

    float dk[OT][4], dv[OT][4];
#pragma unroll
    for (int i = 0; i < OT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) { dk[i][c] = 0.0f; dv[i][c] = 0.0f; }

    const T* k_w = smem + L::kK + 16 * warp * S;
    const T* v_w = smem + L::kV + 16 * warp * S;
    const int t2 = 2 * (lane & 3);  // this thread's first column of a tile
    const int n_tiles = p.t / BQ;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int stage = tile & 1;
        if (tile + 1 < n_tiles) {
            copy_stage(tile + 1, stage ^ 1);
            flash_mma::cp_async_wait<1>();  // tile `tile` (and K, V) landed
        } else {
            flash_mma::cp_async_wait<0>();
        }
        __syncthreads();
        const T* q_s = smem + L::kQ + stage * BQ * S;
        const T* do_s = smem + L::kDo + stage * BQ * S;
        const float* lse_s = stats + 2 * stage * BQ;
        const float* dl_s = lse_s + BQ;

        // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
        float s[QT][4], dp[QT][4];
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) { s[j][c] = 0.0f; dp[j][c] = 0.0f; }
        W::template gemm_nt<QT, D, S>(s, k_w, q_s, lane);
        W::template gemm_nt<QT, D, S>(dp, v_w, do_s, lane);

        // P^T = exp2(s^2 log2(e) S^T - lse log2(e)), dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int j = 0; j < QT; ++j) {
            const float2 lse = *reinterpret_cast<const float2*>(
                lse_s + 8 * j + t2);
            const float2 dlt = *reinterpret_cast<const float2*>(
                dl_s + 8 * j + t2);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float l2 = ((c & 1) ? lse.y : lse.x) * kLog2e;
                const float pv = exp2f(s[j][c] * p.logit_scale - l2);
                s[j][c] = pv;
                dp[j][c] = pv * (dp[j][c] - ((c & 1) ? dlt.y : dlt.x));
            }
        }

        // dV += P^T dO and dK += dS^T Q over this tile's queries
        W::template gemm_pn<QT, OT, S>(dv, s, do_s + col0, lane);
        W::template gemm_pn<QT, OT, S>(dk, dp, q_s + col0, lane);
        __syncthreads();  // everyone is done with this stage before the
                          // copy of tile + 2 is issued into it
    }

    const long long row0 = k0 + 16 * warp;
    T* dk_g = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh
        + row0 * p.dk_st + col0;
    T* dv_g = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh
        + row0 * p.dv_st + col0;
    flash_mma::store_rows<T, OT>(dk_g, p.dk_st, dk, p.grad_scale,
                                 p.grad_scale, lane);
    flash_mma::store_rows<T, OT>(dv_g, p.dv_st, dv, 1.0f, 1.0f, lane);
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
    constexpr int kBytes = DqLayout<D, BQ, BK>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / BQ, batch * p.heads);
    flash_bwd_dq_kernel<T, D, BQ, BK><<<grid, kThreads, kBytes, stream>>>(p);
    return cudaGetLastError();
}

template <typename T, int D, int DO, int BK, int BQ>
cudaError_t launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
    constexpr int kBytes = DkvLayout<T, D, BK, BQ>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D, DO, BK, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / BK, batch * p.heads, D / DO);
    flash_bwd_dkv_kernel<T, D, DO, BK, BQ><<<grid, 2 * BK, kBytes, stream>>>(
        p);
    return cudaGetLastError();
}

// dq tiles (BQ x BK): 64 x 64 except at D = 256 (64 x 32), where the D-wide
// tiles would not fit in shared memory. dkv tiles (output columns DO, BK keys
// x BQ queries), chosen so that ptxas spills nothing up to D = 128 (a thread
// holds dK and dV, D/2 registers each, S^T and dP^T, BQ/2 each, and the
// products' fragments): 128 keys (8 warps) and 32-query tiles up to D = 64;
// at D = 128 16-query tiles for float32, and two column halves of 64 with
// 32-query tiles for bfloat16 (whose fragments take more registers); at
// D = 256 two column halves of 128, 64 keys and 16-query tiles (the float32
// K, V and the Q/dO ring take 200 KB).
template <typename T>
cudaError_t launch_for_d(const BwdParams& p, int batch, int d, bool dkv,
                         cudaStream_t stream) {
    constexpr bool kBf16 = sizeof(T) == 2;
    if (dkv) {
        switch (d) {
            case 32: return launch_dkv<T, 32, 32, 128, 64>(p, batch, stream);
            case 64: return launch_dkv<T, 64, 64, 128, 32>(p, batch, stream);
            case 128:
                if constexpr (kBf16)
                    return launch_dkv<T, 128, 64, 128, 32>(p, batch, stream);
                else
                    return launch_dkv<T, 128, 128, 128, 16>(p, batch, stream);
            case 256:
                return launch_dkv<T, 256, 128, 64, 16>(p, batch, stream);
            default: return cudaErrorInvalidValue;
        }
    }
    switch (d) {
        case 32: return launch_dq<T, 32, 64, 64>(p, batch, stream);
        case 64: return launch_dq<T, 64, 64, 64>(p, batch, stream);
        case 128: return launch_dq<T, 128, 64, 64>(p, batch, stream);
        case 256: return launch_dq<T, 256, 64, 32>(p, batch, stream);
        default: return cudaErrorInvalidValue;
    }
}

int launch(bool dkv, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, int batch, int heads, int t, int d, int dtype,
           const long long* s, void* stream) {
    if (batch <= 0 || heads <= 0 || t <= 0 || t % 128 != 0 ||
        static_cast<long long>(batch) * heads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    BwdParams p;
    p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
    p.dq = dq; p.dk = dk; p.dv = dv;
    p.heads = heads; p.t = t;
    p.q_sb = s[0]; p.q_sh = s[1]; p.q_st = s[2];
    p.k_sb = s[3]; p.k_sh = s[4]; p.k_st = s[5];
    p.v_sb = s[6]; p.v_sh = s[7]; p.v_st = s[8];
    p.do_sb = s[9]; p.do_sh = s[10]; p.do_st = s[11];
    p.dq_sb = s[12]; p.dq_sh = s[13]; p.dq_st = s[14];
    p.dk_sb = s[15]; p.dk_sh = s[16]; p.dk_st = s[17];
    p.dv_sb = s[18]; p.dv_sh = s[19]; p.dv_st = s[20];
    p.grad_scale = 1.0f / sqrtf(static_cast<float>(d));
    p.logit_scale = kLog2e * p.grad_scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0)
        err = launch_for_d<float>(p, batch, d, dkv, st);
    else if (dtype == 1)
        err = launch_for_d<__nv_bfloat16>(p, batch, d, dkv, st);
    else
        err = cudaErrorInvalidValue;
    return static_cast<int>(err);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; q, k, v, dout (and dq, dk, dv) of that type,
// lse and delta float32 (B*H, T) contiguous. t must be a multiple of 128.
// `strides` holds 21 element strides, (batch, head, row) of q, k, v, dout,
// dq, dk, dv in that order; the last dimension of each is contiguous. Each
// entry launches one kernel on `stream`, does not synchronise, allocates
// nothing, and returns the CUDA error code.
extern "C" int pai_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int batch, int heads, int t, int d, int dtype, const long long* strides,
    void* stream) {
    return launch(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                  batch, heads, t, d, dtype, strides, stream);
}

extern "C" int pai_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int batch, int heads, int t, int d, int dtype, const long long* strides,
    void* stream) {
    return launch(true, q, k, v, dout, lse, delta, nullptr, dk, dv,
                  batch, heads, t, d, dtype, strides, stream);
}

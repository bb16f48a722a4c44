// Flash-attention backward for Hopper (sm_90a) on the tensor cores.
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
// 8*B*H*T*D elements moved. So every product of both kernels runs as
// warp-level mma.sync on the tensor cores (flash_mma.cuh): bf16 m16n8k16 for
// bfloat16 operands (P and dS, float32 values, as two bf16 terms), 3xTF32
// m16n8k8 for float32 ones (float32 accuracy, never TF32 alone).
//
// * Each output tile has exactly one writer, as on the TPU: dq's block owns
//   one (batch*head, query tile) and loops over the K/V tiles; dkv's block
//   owns one (batch*head, key tile) and loops over the query tiles. No
//   atomics and a fixed order of mma accumulation, so the result is
//   bit-reproducible, and lse and delta are inputs, never recomputed inside:
//   a caller may pass a global lse that spans more keys than the ones it
//   hands over (ring attention's hops).
// * The products that sum over the long axis (dQ over the keys, dK and dV
//   over the queries) add partial sums of 32 in float32, because the tensor
//   cores' own accumulation truncates (flash_mma.cuh, kPnKeys).
// * Each kernel's design is described above it.
//
// Dynamic shared memory (up to 202,752 bytes), so each instantiation is given
// cudaFuncAttributeMaxDynamicSharedMemorySize before its launch. Plain C
// interface; each entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::Warp;
using flash_mma::kLog2e;

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

// ------------------------------------------------------------------- dQ
// The forward's shape (flash_attention.cu): one block owns BQ query rows of
// one batch*head and loops over BK-key tiles; each of its BQ/16 warps owns 16
// query rows. Per key tile, three products:
//     S = Q K^T,  dP = dO V^T     (A: the warp's Q and dO rows in shared
//                                  memory, copied once; B: the K, V tile)
//     dQ += dS K                  (A: dS straight from the accumulator
//                                  fragments, in registers; B: the K tile,
//                                  its rows in gemm_pn's order)
// P = exp2(s^2 log2(e) S - lse log2(e)) and dS = P (dP - delta) are formed in
// the fragments: each thread holds lse and delta of its rows g and g + 8 in
// registers for the whole loop, and its D/2 floats of dQ from the first tile
// to the last. K and V arrive by cp.async in a ring of two stages: tile i + 1
// is in flight while tile i is multiplied.
template <typename T, int D, int BQ, int BK> struct DqLayout {
    static constexpr int kStride = D + Warp<T>::kPad;  // elements per row
    static constexpr int kQ = 0;
    static constexpr int kDo = kQ + BQ * kStride;
    static constexpr int kK = kDo + BQ * kStride;       // 2 stages
    static constexpr int kV = kK + 2 * BK * kStride;    // 2 stages
    static constexpr int kElems = kV + 2 * BK * kStride;
    static constexpr int kBytes = kElems * static_cast<int>(sizeof(T));
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ, 1)
flash_bwd_dq_kernel(const BwdParams p) {
    using L = DqLayout<T, D, BQ, BK>;
    using W = Warp<T>;
    constexpr int NT = 2 * BQ;       // threads: BQ / 16 warps
    constexpr int S = L::kStride;
    constexpr int KT = BK / 8;       // 8-column tiles of S and dP (keys)
    constexpr int DT = D / 8;        // 8-column tiles of dQ

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bh = blockIdx.y;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int q0 = blockIdx.x * BQ;
    const int row0 = 16 * warp;

    const T* q_g = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
        + static_cast<long long>(q0) * p.q_st;
    const T* do_g = static_cast<const T*>(p.dout) + b * p.do_sb
        + h * p.do_sh + static_cast<long long>(q0) * p.do_st;
    const T* k_g = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v_g = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

    // K and V of key tile `tile` into ring stage `stage`
    auto copy_stage = [&](int tile, int stage) {
        const long long k0 = static_cast<long long>(tile) * BK;
        flash_mma::copy_tile<T, BK, D, S, NT>(
            smem + L::kK + stage * BK * S, k_g + k0 * p.k_st, p.k_st, tid);
        flash_mma::copy_tile<T, BK, D, S, NT>(
            smem + L::kV + stage * BK * S, v_g + k0 * p.v_st, p.v_st, tid);
        flash_mma::cp_async_commit();
    };

    flash_mma::copy_tile<T, BQ, D, S, NT>(smem + L::kQ, q_g, p.q_st, tid);
    flash_mma::copy_tile<T, BQ, D, S, NT>(smem + L::kDo, do_g, p.do_st, tid);
    copy_stage(0, 0);  // one group with Q and dO

    // lse (in log2 units) and delta of this thread's rows g and g + 8
    const long long row = static_cast<long long>(bh) * p.t + q0 + row0
        + (lane >> 2);
    const float lse2[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
    const float dlt[2] = {p.delta[row], p.delta[row + 8]};

    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    const T* q_w = smem + L::kQ + row0 * S;
    const T* do_w = smem + L::kDo + row0 * S;
    const int n_tiles = p.t / BK;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int stage = tile & 1;
        if (tile + 1 < n_tiles) {
            copy_stage(tile + 1, stage ^ 1);
            flash_mma::cp_async_wait<1>();  // tile `tile` (and Q, dO) landed
        } else {
            flash_mma::cp_async_wait<0>();
        }
        __syncthreads();
        const T* k_s = smem + L::kK + stage * BK * S;
        const T* v_s = smem + L::kV + stage * BK * S;

        // S = Q K^T and dP = dO V^T: rows queries, columns keys
        float s[KT][4], dp[KT][4];
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) { s[j][c] = 0.0f; dp[j][c] = 0.0f; }
        W::template gemm_nt<KT, D, S>(s, q_w, k_s, lane);
        W::template gemm_nt<KT, D, S>(dp, do_w, v_s, lane);

        // P = exp2(s^2 log2(e) S - lse log2(e)), dS = P (dP - delta) in dp;
        // element c of a tile is row g + 8 (c >> 1)
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float pv = exp2f(s[j][c] * p.logit_scale
                                       - lse2[c >> 1]);
                dp[j][c] = pv * (dp[j][c] - dlt[c >> 1]);
            }

        // dQ += dS K over this tile's keys
        W::template gemm_pn<KT, DT, S>(acc, dp, k_s, lane);
        __syncthreads();  // everyone is done with this stage before the
                          // copy of tile + 2 is issued into it
    }

    T* dq_g = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh
        + static_cast<long long>(q0 + row0) * p.dq_st;
    flash_mma::store_rows<T, DT>(dq_g, p.dq_st, acc, p.grad_scale,
                                 p.grad_scale, lane);
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
    constexpr int kBytes = DqLayout<T, D, BQ, BK>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / BQ, batch * p.heads);
    flash_bwd_dq_kernel<T, D, BQ, BK><<<grid, 2 * BQ, kBytes, stream>>>(p);
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

// Tiles, chosen so that ptxas spills nothing up to D = 128. dq (BQ queries
// x BK keys; a thread holds dQ, D/2 registers, S and dP, BK/2 each, and the
// products' fragments): float32 128 queries (8 warps) and 64-key tiles up to
// D = 64, 32-key tiles at D = 128 (Q, dO and the K/V ring then take 198 KB);
// bfloat16 the same at D = 32, else 64 queries (4 warps: two blocks share an
// SM, which ran faster than 128 queries on an H100) with 64-key tiles at
// D = 64 and 32-key tiles at D = 128 (64 keys spill there); at
// D = 256 64 queries and 16-key tiles (float32: 195 KB). dkv (output
// columns DO, BK keys x BQ queries; a thread holds dK and dV, D/2 registers
// each, S^T and dP^T, BQ/2 each): 128 keys (8 warps) and 32-query tiles up to
// D = 64; at D = 128 16-query tiles for float32, and two column halves of 64
// with 32-query tiles for bfloat16 (whose fragments take more registers); at
// D = 256 two column halves of 128, 64 keys and 16-query tiles (the float32
// K, V and the Q/dO ring take 195 KB).
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
        case 32: return launch_dq<T, 32, 128, 64>(p, batch, stream);
        case 64:
            if constexpr (kBf16)
                return launch_dq<T, 64, 64, 64>(p, batch, stream);
            else
                return launch_dq<T, 64, 128, 64>(p, batch, stream);
        case 128:
            if constexpr (kBf16)
                return launch_dq<T, 128, 64, 32>(p, batch, stream);
            else
                return launch_dq<T, 128, 128, 32>(p, batch, stream);
        case 256: return launch_dq<T, 256, 64, 16>(p, batch, stream);
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

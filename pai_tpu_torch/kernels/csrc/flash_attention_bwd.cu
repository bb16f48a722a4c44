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
//     dQ = s^2 dS K                      flash_bwd_dq_kernel, and at
//                                        D = 64 (bf16 and float32) and
//                                        D = 128 (bf16)
//                                        flash_bwd_dq_wgmma_kernel
//     dV = P^T dO,  dK = s^2 dS^T Q      flash_bwd_dkv_kernel, and at
//                                        D = 64 and 128 (bf16 and float32)
//                                        flash_bwd_dkv_wgmma_kernel
//
// Operands are float or bfloat16; P and dS are float32 and every sum is
// float32; the outputs are written in the operands' type.
//
// What bounds them on an H100: operations. dq does three products of
// 2*T^2*D per head (6*B*H*T^2*D), dkv four (8*B*H*T^2*D), against some
// 8*B*H*T*D elements moved. So every product of both kernels runs on the
// tensor cores, bfloat16 operands with P and dS (float32 values) as two
// bf16 terms, float32 operands as 3xTF32 (float32 accuracy, never TF32
// alone). On Hopper's warpgroup wgmma with TMA tile loads
// (flash_wgmma.cuh): both kernels in bfloat16 at D = 64 and D = 128 (the
// bf16-mixed Palette path's shapes), and in float32 (the CLI default's) dkv
// there too and dq at D = 64, both on the TF32 hi and lo planes of one
// split pass per backward call (flash_split.cu).
// Everything else on warp-level mma.sync (flash_mma.cuh): bf16 m16n8k16
// for bfloat16 operands, 3xTF32 m16n8k8 for float32 ones. launch_for_d
// fixes the route by (dtype, D).
//
// * Each output tile has exactly one writer, as on the TPU: dq's block owns
//   one (batch*head, query tile) and loops over the K/V tiles; dkv's block
//   owns one (batch*head, key tile) and loops over the query tiles. No
//   atomics and a fixed order of accumulation, so the result is
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
// interface; each entry returns the CUDA error code (a tensor map the driver
// refuses is cudaErrorInvalidValue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "flash_mma.cuh"
#include "flash_wgmma.cuh"

namespace {

using flash_mma::Warp;
using flash_mma::kLog2e;
using flash_mma::smem_addr;

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

// ------------------------------------------------------ dK, dV: wgmma route
// bfloat16 at D = 64 and D = 128 (flash_wgmma.cuh). One block of two
// warpgroups owns 64 keys of one batch*head, all D columns (no column split:
// S^T and dP^T are computed once per query tile). K and V are loaded once by
// TMA and stay in shared memory; BQ-row Q and dO tiles, with their lse and
// delta rows (bulk copies), stream through a ring of STAGES stages. The two
// warpgroups split the products, each holding one D-wide float32
// accumulator (D/2 registers a thread) from the first query tile to the
// last:
//   warpgroup 0:  S^T = K Q^T                  SS wgmmas, BQ wide
//                 P^T = exp2(s^2 log2(e) S^T - lse log2(e))
//                 -> P^T to shared memory for warpgroup 1
//                 dV += P^T dO                 RS wgmmas
//   warpgroup 1:  dP^T = V dO^T                SS wgmmas, BQ wide
//                 dS^T = P^T (dP^T - delta)    P^T from shared memory
//                 dK += dS^T Q                 RS wgmmas
// so each runs three of the six products' worth of tensor work (P^T and
// dS^T enter as hi and lo bf16 terms), and warpgroup 1's elementwise work
// runs while warpgroup 0's dV wgmmas do. The RS products run per 64-column
// box in partials of 32 queries (kPnKeys), each a fresh accumulator added in
// float32, two in flight. P^T passes through two shared-memory buffers, each
// with a `full` and an `empty` mbarrier (128 arrivals: every thread of one
// warpgroup); the two warpgroups' fragments lie alike, so thread t of
// warpgroup 1 reads what thread t of warpgroup 0 wrote. A ring stage is
// released by one arrival per warp of both warpgroups; warpgroup 1, which
// waits for P^T and so runs behind, refills it (refilled by a thread of
// warpgroup 0, which then waited for warpgroup 1 every tile, the kernel was
// slower).
// What bounds it: the CUDA-core work besides the products (the exponential,
// dS^T, the hi/lo splits and the partial adds: some 15 instructions per
// element of S^T, the adds 2 D / 32 of them) and each warpgroup's waits for
// its own wgmmas. Holding both dK and dV in each warpgroup (128 keys a
// block) took 255 registers and spilled at D = 128; split, the block takes
// 216 (D = 64, BQ = 128) and 226 (D = 128, BQ = 64) and spills nothing.
template <int D, int BQ, int STAGES> struct DkvWgmmaLayout {
    static constexpr int kBK = 64;
    static constexpr int kBoxes = D / flash_wgmma::kBoxCols;
    static constexpr int kKvBox = kBK * flash_wgmma::kRowBytes;  // bytes
    static constexpr int kQBox = BQ * flash_wgmma::kRowBytes;
    static constexpr int kK = 0;
    static constexpr int kV = kK + kBoxes * kKvBox;
    static constexpr int kQ = kV + kBoxes * kKvBox;
    static constexpr int kDo = kQ + STAGES * kBoxes * kQBox;
    static constexpr int kLse = kDo + STAGES * kBoxes * kQBox;  // float32
    static constexpr int kDelta = kLse + STAGES * BQ * 4;
    static constexpr int kP = kDelta + STAGES * BQ * 4;  // 2 x 64 x BQ floats
    static constexpr int kPBuf = kBK * BQ * 4;
    static constexpr int kBar = kP + 2 * kPBuf;
    // barriers: K and V; Q full, dO full and empty of each stage; P full
    // and P empty of each buffer
    static constexpr int kBytes = kBar + 8 * (1 + 3 * STAGES + 4) + 1024;
    static constexpr uint32_t kTileBytes = BQ * D * 2 + BQ * 4;
};

template <int STAGES> struct DkvBarriers {
    uint32_t base;
    __device__ uint32_t kv() const { return base; }
    __device__ uint32_t q(int s) const { return base + 8 * (1 + s); }
    __device__ uint32_t dout(int s) const {
        return base + 8 * (1 + STAGES + s);
    }
    __device__ uint32_t empty(int s) const {
        return base + 8 * (1 + 2 * STAGES + s);
    }
    __device__ uint32_t p_full(int i) const {
        return base + 8 * (1 + 3 * STAGES + i);
    }
    __device__ uint32_t p_empty(int i) const {
        return base + 8 * (3 + 3 * STAGES + i);
    }
};

// Q with its lse rows and dO with its delta rows of query tile `tile` into
// its ring stage (thread 0 only).
template <int D, int BQ, int STAGES>
__device__ __forceinline__ void dkv_load_tile(const CUtensorMap* tm_q,
                                              const CUtensorMap* tm_do,
                                              const BwdParams& p, int bh,
                                              uint32_t base,
                                              DkvBarriers<STAGES> bar,
                                              int tile) {
    using L = DkvWgmmaLayout<D, BQ, STAGES>;
    namespace fw = flash_wgmma;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const long long row = static_cast<long long>(bh) * p.t + tile * BQ;
    const int s = tile % STAGES;
    const uint32_t q_s = base + L::kQ + s * L::kBoxes * L::kQBox;
    const uint32_t do_s = base + L::kDo + s * L::kBoxes * L::kQBox;
    fw::mbar_expect_tx(bar.q(s), L::kTileBytes);
    for (int box = 0; box < L::kBoxes; ++box)
        fw::tma_load(q_s + box * L::kQBox, tm_q, bar.q(s),
                     box * fw::kBoxCols, tile * BQ, h, b);
    fw::bulk_load(base + L::kLse + s * BQ * 4, p.lse + row, BQ * 4, bar.q(s));
    fw::mbar_expect_tx(bar.dout(s), L::kTileBytes);
    for (int box = 0; box < L::kBoxes; ++box)
        fw::tma_load(do_s + box * L::kQBox, tm_do, bar.dout(s),
                     box * fw::kBoxCols, tile * BQ, h, b);
    fw::bulk_load(base + L::kDelta + s * BQ * 4, p.delta + row, BQ * 4,
                  bar.dout(s));
}

// One warpgroup's side: wg 0 (S^T, P^T, dV) or 1 (dP^T, dS^T, dK).
template <typename T, int D, int BQ, int STAGES>
__device__ __forceinline__ void dkv_consume(const BwdParams& p,
                                            const CUtensorMap* tm_q,
                                            const CUtensorMap* tm_do,
                                            unsigned char* smem,
                                            DkvBarriers<STAGES> bar, int bh,
                                            int k0, int wg, int n_tiles) {
    using L = DkvWgmmaLayout<D, BQ, STAGES>;
    using MMA_S = flash_wgmma::Wgmma<BQ>;
    namespace fw = flash_wgmma;
    constexpr int QT = BQ / 8;  // 8-column tiles of S^T (queries)
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int warp = tid >> 5;      // within the warpgroup
    const int t2 = 2 * (lane & 3);  // this thread's first column of a tile
    const uint32_t base = smem_addr(smem);
    // warpgroup 0 multiplies K by Q and P^T by dO; warpgroup 1 V by dO and
    // dS^T by Q
    const uint32_t a_w = base + (wg == 0 ? L::kK : L::kV);

    float acc[D / 8][4];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    fw::mbar_wait(bar.kv(), 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int s = tile % STAGES;
        const uint32_t parity = (tile / STAGES) & 1;
        const uint32_t q_s = base + L::kQ + s * L::kBoxes * L::kQBox;
        const uint32_t do_s = base + L::kDo + s * L::kBoxes * L::kQBox;
        // warpgroup 1, which waits for warpgroup 0's P^T and so runs
        // behind it, refills the stage of the tile before: its first thread
        // finds both warpgroups done with it and never holds warpgroup 0 up
        const int refill = tile - 1 + STAGES;
        if (threadIdx.x == 128 && tile > 0 && refill < n_tiles) {
            fw::mbar_wait(bar.empty((tile - 1) % STAGES),
                          ((tile - 1) / STAGES) & 1);
            dkv_load_tile<D, BQ, STAGES>(tm_q, tm_do, p, bh, base, bar,
                                         refill);
        }

        // ---- S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1):
        // rows keys, columns queries
        const uint32_t a_t = fw::opaque(a_w);
        const uint32_t b_s = wg == 0 ? q_s : do_s;
        float sc[QT][4];
        fw::mbar_wait(wg == 0 ? bar.q(s) : bar.dout(s), parity);
        fw::wgmma_fence();
        MMA_S::ss_first(sc, fw::kmajor_desc(a_t, L::kKvBox, 0),
                        fw::kmajor_desc(b_s, L::kQBox, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
            MMA_S::ss(sc, fw::kmajor_desc(a_t, L::kKvBox, kk),
                      fw::kmajor_desc(b_s, L::kQBox, kk));
        fw::wgmma_commit();
        fw::wgmma_wait<0>();
        fw::fence_regs(sc);

        // ---- P^T, through shared memory, and dS^T
        const int buf = tile & 1;
        const uint32_t use = (tile >> 1) & 1;  // parity of this buffer's use
        float4* p_buf = reinterpret_cast<float4*>(smem + L::kP
                                                  + buf * L::kPBuf) + tid;
        if (wg == 0) {
            const float* lse_s = reinterpret_cast<const float*>(
                smem + L::kLse) + s * BQ;
#pragma unroll
            for (int j = 0; j < QT; ++j) {
                const float2 lse = *reinterpret_cast<const float2*>(
                    lse_s + 8 * j + t2);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float l2 = ((c & 1) ? lse.y : lse.x) * kLog2e;
                    sc[j][c] = fw::exp2_ftz(fmaf(sc[j][c], p.logit_scale,
                                                 -l2));
                }
            }
            if (tile >= 2) fw::mbar_wait(bar.p_empty(buf), use ^ 1);
#pragma unroll
            for (int j = 0; j < QT; ++j)
                p_buf[128 * j] = make_float4(sc[j][0], sc[j][1], sc[j][2],
                                             sc[j][3]);
            fw::mbar_arrive(bar.p_full(buf));
            fw::mbar_wait(bar.dout(s), parity);  // dO, for dV
        } else {
            const float* dl_s = reinterpret_cast<const float*>(
                smem + L::kDelta) + s * BQ;
            fw::mbar_wait(bar.p_full(buf), use);
#pragma unroll
            for (int j = 0; j < QT; ++j) {
                const float4 pv = p_buf[128 * j];
                const float2 dlt = *reinterpret_cast<const float2*>(
                    dl_s + 8 * j + t2);
                sc[j][0] = pv.x * (sc[j][0] - dlt.x);
                sc[j][1] = pv.y * (sc[j][1] - dlt.y);
                sc[j][2] = pv.z * (sc[j][2] - dlt.x);
                sc[j][3] = pv.w * (sc[j][3] - dlt.y);
            }
            fw::mbar_arrive(bar.p_empty(buf));
            fw::mbar_wait(bar.q(s), parity);  // Q, for dK
        }

        // ---- dV += P^T dO or dK += dS^T Q over this tile's queries, in
        // partials of kPnKeys
        uint32_t a_hi[QT / 2][4], a_lo[QT / 2][4];
#pragma unroll
        for (int i = 0; i < QT / 2; ++i)
            fw::split_step(sc, i, a_hi[i], a_lo[i]);
        fw::add_partials_bf16<BQ, L::kBoxes>(acc, a_hi, a_lo,
                                             wg == 0 ? do_s : q_s, L::kQBox);
        __syncwarp();
        if (lane == 0) fw::mbar_arrive(bar.empty(s));
    }

    // warpgroup 0 writes dV, warpgroup 1 dK (times s^2)
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const long long row0 = k0 + 16 * warp;
    T* out = wg == 0
        ? static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh + row0 * p.dv_st
        : static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh + row0 * p.dk_st;
    const long long stride = wg == 0 ? p.dv_st : p.dk_st;
    const float scale = wg == 0 ? 1.0f : p.grad_scale;
    flash_mma::store_rows<T, D / 8>(out, stride, acc, scale, scale, lane);
}

template <typename T, int D, int BQ, int STAGES>
__global__ void __launch_bounds__(flash_wgmma::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const BwdParams p) {
    static_assert(sizeof(T) == 2, "the bf16 wgmma route");
    using L = DkvWgmmaLayout<D, BQ, STAGES>;
    namespace fw = flash_wgmma;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = fw::align_1024(smem_raw);
    const uint32_t base = smem_addr(smem);
    const DkvBarriers<STAGES> bar{base + L::kBar};
    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * L::kBK;
    const int n_tiles = p.t / BQ;

    if (threadIdx.x == 0) {
        fw::mbar_init(bar.kv(), 1);
        for (int s = 0; s < STAGES; ++s) {
            fw::mbar_init(bar.q(s), 1);
            fw::mbar_init(bar.dout(s), 1);
            fw::mbar_init(bar.empty(s), 8);  // every warp
        }
        for (int i = 0; i < 2; ++i) {
            fw::mbar_init(bar.p_full(i), 128);   // warpgroup 0's threads
            fw::mbar_init(bar.p_empty(i), 128);  // warpgroup 1's threads
        }
        fw::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // K and V, and the first STAGES query tiles
        const int b = bh / p.heads;
        const int h = bh % p.heads;
        fw::mbar_expect_tx(bar.kv(), 2 * L::kBK * D * 2);
        for (int box = 0; box < L::kBoxes; ++box) {
            fw::tma_load(base + L::kK + box * L::kKvBox, &tm_k, bar.kv(),
                         box * fw::kBoxCols, k0, h, b);
            fw::tma_load(base + L::kV + box * L::kKvBox, &tm_v, bar.kv(),
                         box * fw::kBoxCols, k0, h, b);
        }
        for (int tile = 0; tile < STAGES && tile < n_tiles; ++tile)
            dkv_load_tile<D, BQ, STAGES>(&tm_q, &tm_do, p, bh, base, bar,
                                         tile);
    }
    dkv_consume<T, D, BQ, STAGES>(p, &tm_q, &tm_do, smem, bar, bh, k0,
                                  threadIdx.x >> 7, n_tiles);
}

// The split pass's fourteen planes of a float32 backward call, read by
// both kernels, in its order: Q hi, Q lo, Q^T hi, Q^T lo, K hi, K lo, K^T
// hi, K^T lo, V hi, V lo, dO hi, dO lo, dO^T hi, dO^T lo (each operand's
// K-major planes, then its transposed ones; V has no transposed planes).
// A kernel's tensor maps are indexed alike; the maps of planes it does not
// read stay zero.
constexpr int kPlanes = 14;
constexpr int kPlaneQ = 0, kPlaneQt = 2, kPlaneK = 4, kPlaneKt = 6,
              kPlaneV = 8, kPlaneDo = 10, kPlaneDot = 12;
struct alignas(64) BwdTf32Maps {
    CUtensorMap m[kPlanes];
};

// ---------------------------------------------- dK, dV: wgmma, float32
// float32 at D = 64 and D = 128 (the CLI default's Palette training shapes)
// as 3xTF32 on wgmma m64nNk8: the bf16 route's block and split of the
// products between its two warpgroups, every operand a pair of TF32 hi
// and lo tiles from the split pass's planes (flash_split.cu): K, V, Q and
// dO K-major, Q^T and dO^T (D rows of queries, each 8 permuted to match
// the accumulator's fragment) for the two products that sum over queries.
// One block owns 64 keys of one batch*head:
//   warpgroup 0:  S^T = K Q^T          SS, A K, B Q (hi, lo)
//                 P^T = exp2(s^2 log2(e) S^T - lse log2(e)) -> shared
//                 dV += P^T dO         RS, A P^T, B dO^T (hi, lo)
//   warpgroup 1:  dP^T = V dO^T        SS, A V, B dO (hi, lo)
//                 dS^T = P^T (dP^T - delta)
//                 dK += dS^T Q         RS, A dS^T, B Q^T (hi, lo)
// each product 3 terms a step (lo x hi, hi x lo, hi x hi), the RS ones in
// partials of 32 queries (or BQ, if fewer) per 64 columns, two in flight
// (add_partials_tf32). Each warpgroup loads what it alone reads, by TMA
// issued by its first thread: K (warpgroup 0) or V (1) once, and per query
// tile its SS operand (Q with its lse rows, or dO with its delta rows) into
// a ring of S1 stages and its RS operand (dO^T or Q^T) into a ring of S2
// stages. Only the warpgroup that reads a stage refills it, after a named
// barrier of its 128 threads has seen its wgmmas done: the SS stage once
// S^T (or dP^T) is done (its lse or delta rows are then in registers), the
// RS stage once the partials are done. The refills are predicated, not
// branched on the first thread (tma_load_if): a branch of one thread there
// made ptxas serialise the wgmmas (C7520).
// P^T passes to warpgroup 1 through two shared buffers as in the bf16
// route. What bounds it: shared memory. A query tile takes eight planes
// (Q, dO, Q^T, dO^T, hi and lo), 32 BQ D bytes, and K and V hi and lo take
// 1 KB D, so the tiles are small: (BQ, S1, S2) = (64, 1, 1) at D = 64
// (226 KB) and (16, 1, 1) at D = 128 (201 KB; the transposed tiles there
// are 16 queries of 64-byte rows, swizzled 64 bytes; a second stage of
// either ring does not fit), and each tile's eight planes come from L2 for
// every 64 keys. At D = 64, (32, 2, 2) ran 1.25x and (32, 1, 1) 1.39x the
// time of (64, 1, 1): the wider SS products (N = 64) outweigh the second
// stage (tools/flash_f32_tiles.py; PERF.md).
template <int D, int BQ, int S1, int S2> struct DkvTf32Layout {
    static constexpr int kBK = 64;
    static constexpr int kKvPlane = kBK * D * 4;  // bytes: K hi (lo, V ..)
    static constexpr int kKvBox = kBK * flash_wgmma::kRowBytes;
    static constexpr int kQPlane = BQ * D * 4;    // Q hi (lo, dO, Q^T ..)
    static constexpr int kQBox = BQ * flash_wgmma::kRowBytes;
    // transposed tiles: D rows of BQ queries, in boxes of 32 (rows of 128
    // bytes) or, at BQ = 16, one box of 64-byte rows
    static constexpr int kTRowBytes = BQ >= 32 ? flash_wgmma::kRowBytes
                                               : BQ * 4;
    static constexpr int kTBox = D * kTRowBytes;
    static constexpr int kTBoxCols = kTRowBytes / 4;
    static constexpr int kStage = 2 * kQPlane;    // hi and lo
    static constexpr int kK = 0;                  // K hi, K lo, V hi, V lo
    static constexpr int kR1 = 4 * kKvPlane;      // [warpgroup][S1]
    static constexpr int kR2 = kR1 + 2 * S1 * kStage;  // [warpgroup][S2]
    static constexpr int kStats = kR2 + 2 * S2 * kStage;  // [wg][S1] BQ
    static constexpr int kP = kStats + 2 * S1 * BQ * 4;   // 2 x 64 x BQ
    static constexpr int kPBuf = kBK * BQ * 4;
    static constexpr int kBar = kP + 2 * kPBuf;
    // barriers: K or V of each warpgroup; R1 full [wg][S1]; R2 full
    // [wg][S2]; P full and P empty of each buffer
    static constexpr int kBarriers = 2 + 2 * S1 + 2 * S2 + 4;
    static constexpr int kBytes = kBar + 8 * kBarriers + 1024;
    static_assert(kBytes <= 232448, "shared memory of one block");
    static_assert(kQPlane % 1024 == 0, "1024-byte aligned tiles");
};

template <int S1, int S2> struct DkvTf32Barriers {
    uint32_t base;
    __device__ uint32_t kv(int wg) const { return base + 8 * wg; }
    __device__ uint32_t r1(int wg, int s) const {
        return base + 8 * (2 + wg * S1 + s);
    }
    __device__ uint32_t r2(int wg, int s) const {
        return base + 8 * (2 + 2 * S1 + wg * S2 + s);
    }
    __device__ uint32_t p_full(int i) const {
        return base + 8 * (2 + 2 * S1 + 2 * S2 + i);
    }
    __device__ uint32_t p_empty(int i) const {
        return base + 8 * (4 + 2 * S1 + 2 * S2 + i);
    }
};

// Warpgroup wg's SS operand of query tile `tile` (Q and lse, or dO and
// delta) into its R1 stage: issued where `issue` holds (its first thread).
template <int D, int BQ, int S1, int S2>
__device__ __forceinline__ void dkv_tf32_load_r1(const BwdTf32Maps& maps,
                                                 const BwdParams& p, int bh,
                                                 uint32_t base,
                                                 DkvTf32Barriers<S1, S2> bar,
                                                 int wg, int tile,
                                                 bool issue) {
    using L = DkvTf32Layout<D, BQ, S1, S2>;
    namespace fw = flash_wgmma;
    const int s = tile % S1;
    const uint32_t dst = base + L::kR1 + (wg * S1 + s) * L::kStage;
    const CUtensorMap* m = &maps.m[wg == 0 ? kPlaneQ : kPlaneDo];
    const long long row = static_cast<long long>(bh) * p.t + tile * BQ;
    fw::mbar_expect_tx_if(issue, bar.r1(wg, s), L::kStage + BQ * 4);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane)
#pragma unroll
        for (int box = 0; box < D / fw::kTf32BoxCols; ++box)
            fw::tma_load_if(issue, dst + plane * L::kQPlane + box * L::kQBox,
                            m + plane, bar.r1(wg, s),
                            box * fw::kTf32BoxCols, tile * BQ, bh % p.heads,
                            bh / p.heads);
    fw::bulk_load_if(issue, base + L::kStats + (wg * S1 + s) * BQ * 4,
                     (wg == 0 ? p.lse : p.delta) + row, BQ * 4,
                     bar.r1(wg, s));
}

// Warpgroup wg's RS operand of query tile `tile` (dO^T, or Q^T) into its R2
// stage: issued where `issue` holds (its first thread).
template <int D, int BQ, int S1, int S2>
__device__ __forceinline__ void dkv_tf32_load_r2(const BwdTf32Maps& maps,
                                                 const BwdParams& p, int bh,
                                                 uint32_t base,
                                                 DkvTf32Barriers<S1, S2> bar,
                                                 int wg, int tile,
                                                 bool issue) {
    using L = DkvTf32Layout<D, BQ, S1, S2>;
    namespace fw = flash_wgmma;
    const int s = tile % S2;
    const uint32_t dst = base + L::kR2 + (wg * S2 + s) * L::kStage;
    const CUtensorMap* m = &maps.m[wg == 0 ? kPlaneDot : kPlaneQt];
    fw::mbar_expect_tx_if(issue, bar.r2(wg, s), L::kStage);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane)
#pragma unroll
        for (int box = 0; box < BQ / L::kTBoxCols; ++box)
            fw::tma_load_if(issue, dst + plane * L::kQPlane + box * L::kTBox,
                            m + plane, bar.r2(wg, s),
                            tile * BQ + box * L::kTBoxCols, 0, bh % p.heads,
                            bh / p.heads);
}

// One warpgroup's side: wg 0 (S^T, P^T, dV) or 1 (dP^T, dS^T, dK).
template <typename T, int D, int BQ, int S1, int S2>
__device__ __forceinline__ void dkv_consume_tf32(const BwdParams& p,
                                                 const BwdTf32Maps& maps,
                                                 unsigned char* smem,
                                                 DkvTf32Barriers<S1, S2> bar,
                                                 int bh, int k0, int wg,
                                                 int n_tiles) {
    using L = DkvTf32Layout<D, BQ, S1, S2>;
    namespace fw = flash_wgmma;
    constexpr int QT = BQ / 8;  // 8-column tiles of S^T (queries)
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int warp = tid >> 5;      // within the warpgroup
    const int t2 = 2 * (lane & 3);  // this thread's first column of a tile
    const bool leader = tid == 0;
    const uint32_t base = smem_addr(smem);
    // warpgroup 0 multiplies K by Q and P^T by dO; warpgroup 1 V by dO and
    // dS^T by Q
    const uint32_t a_w = base + L::kK + wg * 2 * L::kKvPlane;

    float acc[D / 8][4];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    fw::mbar_wait(bar.kv(wg), 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int s1 = tile % S1;
        const int s2 = tile % S2;
        const uint32_t b_s = base + L::kR1 + (wg * S1 + s1) * L::kStage;
        const uint32_t b_t = base + L::kR2 + (wg * S2 + s2) * L::kStage;
        const float* stats = reinterpret_cast<const float*>(
            smem + L::kStats) + (wg * S1 + s1) * BQ;

        // ---- S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1):
        // rows keys, columns queries; lse (or delta) of this thread's
        // columns into registers
        float sc[QT][4];
        float2 stat[QT];
        fw::mbar_wait(bar.r1(wg, s1), (tile / S1) & 1);
#pragma unroll
        for (int j = 0; j < QT; ++j)
            stat[j] = *reinterpret_cast<const float2*>(stats + 8 * j + t2);
        fw::wgmma_fence();
        fw::ss_3xtf32<BQ, D>(sc, fw::opaque(a_w), L::kKvBox, L::kKvPlane,
                             b_s, L::kQBox, L::kQPlane);
        fw::wgmma_commit();
        fw::wgmma_wait<0>();
        fw::fence_regs(sc);
        // the SS stage is read: refill it
        fw::named_barrier(1 + wg, 128);
        if (tile + S1 < n_tiles)
            dkv_tf32_load_r1<D, BQ, S1, S2>(maps, p, bh, base, bar, wg,
                                            tile + S1, leader);

        // ---- P^T, through shared memory, and dS^T
        const int buf = tile & 1;
        const uint32_t use = (tile >> 1) & 1;  // parity of this buffer's use
        float4* p_buf = reinterpret_cast<float4*>(smem + L::kP
                                                  + buf * L::kPBuf) + tid;
        if (wg == 0) {
#pragma unroll
            for (int j = 0; j < QT; ++j) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float l2 = ((c & 1) ? stat[j].y : stat[j].x)
                        * kLog2e;
                    sc[j][c] = fw::exp2_ftz(fmaf(sc[j][c], p.logit_scale,
                                                 -l2));
                }
            }
            if (tile >= 2) fw::mbar_wait(bar.p_empty(buf), use ^ 1);
#pragma unroll
            for (int j = 0; j < QT; ++j)
                p_buf[128 * j] = make_float4(sc[j][0], sc[j][1], sc[j][2],
                                             sc[j][3]);
            fw::mbar_arrive(bar.p_full(buf));
        } else {
            fw::mbar_wait(bar.p_full(buf), use);
#pragma unroll
            for (int j = 0; j < QT; ++j) {
                const float4 pv = p_buf[128 * j];
                sc[j][0] = pv.x * (sc[j][0] - stat[j].x);
                sc[j][1] = pv.y * (sc[j][1] - stat[j].y);
                sc[j][2] = pv.z * (sc[j][2] - stat[j].x);
                sc[j][3] = pv.w * (sc[j][3] - stat[j].y);
            }
            fw::mbar_arrive(bar.p_empty(buf));
        }

        // ---- dV += P^T dO or dK += dS^T Q over this tile's queries
        // (hi and lo in registers of their own: split in place, into the
        // registers that the warpgroups' branches above wrote, ptxas
        // serialised the wgmmas at D = 64, C7520)
        float hi[QT][4], lo[QT][4];
        fw::split_tf32_tiles(sc, hi, lo);
        fw::mbar_wait(bar.r2(wg, s2), (tile / S2) & 1);
        fw::add_partials_tf32<BQ, D / 64, L::kTRowBytes>(
            acc, hi, lo, b_t, b_t + L::kQPlane, L::kTBox);
        fw::named_barrier(1 + wg, 128);
        if (tile + S2 < n_tiles)
            dkv_tf32_load_r2<D, BQ, S1, S2>(maps, p, bh, base, bar, wg,
                                            tile + S2, leader);
    }

    // warpgroup 0 writes dV, warpgroup 1 dK (times s^2)
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const long long row0 = k0 + 16 * warp;
    T* out = wg == 0
        ? static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh + row0 * p.dv_st
        : static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh + row0 * p.dk_st;
    const long long stride = wg == 0 ? p.dv_st : p.dk_st;
    const float scale = wg == 0 ? 1.0f : p.grad_scale;
    flash_mma::store_rows<T, D / 8>(out, stride, acc, scale, scale, lane);
}

template <typename T, int D, int BQ, int S1, int S2>
__global__ void __launch_bounds__(flash_wgmma::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ BwdTf32Maps maps,
                           const BwdParams p) {
    static_assert(sizeof(T) == 4, "the float32 wgmma route");
    using L = DkvTf32Layout<D, BQ, S1, S2>;
    namespace fw = flash_wgmma;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = fw::align_1024(smem_raw);
    const uint32_t base = smem_addr(smem);
    const DkvTf32Barriers<S1, S2> bar{base + L::kBar};
    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * L::kBK;
    const int n_tiles = p.t / BQ;
    // the warpgroup, as a value ptxas sees is the same across a warp: it
    // selects the warpgroup's branch, operands and tensor maps, and a
    // per-thread value there made ptxas serialise the wgmmas (C7520)
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

    if (threadIdx.x == 0) {
        for (int i = 0; i < 2; ++i) {
            fw::mbar_init(bar.kv(i), 1);
            for (int s = 0; s < S1; ++s) fw::mbar_init(bar.r1(i, s), 1);
            for (int s = 0; s < S2; ++s) fw::mbar_init(bar.r2(i, s), 1);
            fw::mbar_init(bar.p_full(i), 128);   // warpgroup 0's threads
            fw::mbar_init(bar.p_empty(i), 128);  // warpgroup 1's threads
        }
        fw::fence_barrier_init();
    }
    __syncthreads();
    if ((threadIdx.x & 127) == 0) {  // K or V, and the first tiles
        const int b = bh / p.heads;
        const int h = bh % p.heads;
        const uint32_t dst = base + L::kK + wg * 2 * L::kKvPlane;
        const CUtensorMap* m = &maps.m[wg == 0 ? kPlaneK : kPlaneV];
        fw::mbar_expect_tx(bar.kv(wg), 2 * L::kKvPlane);
        for (int plane = 0; plane < 2; ++plane)
            for (int box = 0; box < D / fw::kTf32BoxCols; ++box)
                fw::tma_load(dst + plane * L::kKvPlane + box * L::kKvBox,
                             m + plane, bar.kv(wg), box * fw::kTf32BoxCols,
                             k0, h, b);
        for (int tile = 0; tile < S1 && tile < n_tiles; ++tile)
            dkv_tf32_load_r1<D, BQ, S1, S2>(maps, p, bh, base, bar, wg,
                                            tile, true);
        for (int tile = 0; tile < S2 && tile < n_tiles; ++tile)
            dkv_tf32_load_r2<D, BQ, S1, S2>(maps, p, bh, base, bar, wg,
                                            tile, true);
    }
    dkv_consume_tf32<T, D, BQ, S1, S2>(p, maps, smem, bar, bh, k0, wg,
                                       n_tiles);
}

// -------------------------------------------------------- dQ: wgmma route
// bfloat16 at D = 64 and D = 128 (flash_wgmma.cuh); replaces the TPU kernel
// _bwd_dq_kernel (pai_tpu/kernels/flash_attention.py, pallas_call at :290)
// on the bf16-mixed Palette path's shapes. The forward's shape
// (flash_attention.cu, flash_fwd_wgmma_kernel) with one more product and no
// online softmax: one block of two warpgroups owns one (batch*head,
// 128-row query tile), 64 query rows per warpgroup. Thread 0 loads Q and dO
// once and the K and V tiles (BK keys) into a ring of STAGES stages by TMA,
// K and V each on their own `full` barrier; at the start of key tile i it
// refills the stage of tile i - 1 once that stage's `empty` barrier says
// both warpgroups are done with it. Each thread holds lse (in log2 units)
// and delta of its rows g and g + 8 in registers for the whole loop, and its
// D/2 floats of dQ from the first tile to the last. Per key tile a
// warpgroup
//   * issues S = Q K^T and dP = dO V^T as two groups of BK-wide SS wgmmas
//     (K and V read K-major, D/16 steps each), both in flight at once;
//   * forms P = exp2(s^2 log2(e) S - lse log2(e)) in S's accumulators while
//     dP's wgmmas run, then dS = P (dP - delta) in dP's;
//   * adds dS K into dQ in partials of 32 keys (kPnKeys) per 64-column box
//     of K: each a fresh float32 accumulator of four RS wgmmas (dS's two lo
//     terms first, then the two hi terms, as A fragments from registers; K
//     read MN-major from the same 128-byte-swizzled boxes that fed S, so K
//     is loaded once), added to dQ with an ordinary float32 add while the
//     next partial runs (two in flight);
//   * arrives on the stage's `empty` barrier (one arrival per warp).
// lse and delta are taken as given (a ring's hop passes a global lse). The
// epilogue writes dQ s^2 through dq's strides.
// What bounds it: the tensor cores run four products' worth a tile (S, dP,
// and dS K twice, for hi and lo) where the bound counts three; besides them
// some twelve CUDA-core instructions per element of S (the exponential, dS,
// the hi/lo split, the partial adds: 2 D / 32 of them), which a warpgroup
// overlaps only with its own dP wgmmas and with the other warpgroup's.
// Tiles (BK, STAGES): D = 64 (128, 3), 240 registers; D = 128 (64, 3), 228
// registers; no spill. Tried and dropped (tools/flash_dq_tiles.py times
// other tiles; PERF.md): 64-key tiles at D = 64 (slower), four stages at
// D = 128 (no faster), 128-key tiles at D = 128 (spill); and the products
// split across the warpgroups as dkv splits them (warpgroup 0 S and P, P
// through shared memory to warpgroup 1's dP, dS and dQ; 64 query rows a
// block), slower at both head dims: warpgroup 1 then runs three of the
// four products' worth of tensor work alone.
template <int D, int BK, int STAGES> struct DqWgmmaLayout {
    static constexpr int kBQ = 128;
    static constexpr int kBoxes = D / flash_wgmma::kBoxCols;
    static constexpr int kQBox = kBQ * flash_wgmma::kRowBytes;  // bytes
    static constexpr int kKvBox = BK * flash_wgmma::kRowBytes;
    static constexpr int kQ = 0;
    static constexpr int kDo = kQ + kBoxes * kQBox;
    static constexpr int kK = kDo + kBoxes * kQBox;
    static constexpr int kV = kK + STAGES * kBoxes * kKvBox;
    static constexpr int kBar = kV + STAGES * kBoxes * kKvBox;
    // barriers: Q and dO, then K full, V full and empty of each stage
    static constexpr int kBytes = kBar + 8 * (1 + 3 * STAGES) + 1024;
};

// A warpgroup: query rows 64 cw .. 64 cw + 63 of the tile.
template <typename T, int D, int BK, int STAGES>
__device__ __forceinline__ void dq_consume(const BwdParams& p,
                                           const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v,
                                           uint32_t base,
                                           flash_wgmma::KvRing<STAGES> bar,
                                           int bh, int q0, int cw,
                                           int n_tiles) {
    using L = DqWgmmaLayout<D, BK, STAGES>;
    using MMA_S = flash_wgmma::Wgmma<BK>;
    namespace fw = flash_wgmma;
    constexpr int KT = BK / 8;   // 8-column tiles of S and dP (keys)
    constexpr int DT = D / 8;    // 8-column tiles of dQ
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int row0 = q0 + 64 * cw + 16 * warp;  // the warp's first query row
    const uint32_t q_w = base + L::kQ + cw * 64 * fw::kRowBytes;
    const uint32_t do_w = base + L::kDo + cw * 64 * fw::kRowBytes;

    // lse (in log2 units) and delta of this thread's rows g and g + 8
    const long long row = static_cast<long long>(bh) * p.t + row0
        + (lane >> 2);
    const float lse2[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
    const float dlt[2] = {p.delta[row], p.delta[row + 8]};

    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    fw::mbar_wait(bar.once(), 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int s = tile % STAGES;
        const uint32_t parity = (tile / STAGES) & 1;
        const uint32_t k_s = base + L::kK + s * L::kBoxes * L::kKvBox;
        const uint32_t v_s = base + L::kV + s * L::kBoxes * L::kKvBox;
        // thread 0 refills the stage of the tile before, once both
        // warpgroups are done with it
        const int refill = tile - 1 + STAGES;
        if (threadIdx.x == 0 && tile > 0 && refill < n_tiles) {
            fw::mbar_wait(bar.empty((tile - 1) % STAGES),
                          ((tile - 1) / STAGES) & 1);
            fw::load_kv_tile<D, BK, STAGES>(tm_k, tm_v, base + L::kK,
                                            base + L::kV, bar, refill, h, b);
        }

        // ---- S = Q K^T and dP = dO V^T: rows queries, columns keys; two
        // groups in flight
        const uint32_t q_t = fw::opaque(q_w);
        const uint32_t do_t = fw::opaque(do_w);
        float sc[KT][4], dp[KT][4];
        fw::mbar_wait(bar.k(s), parity);
        fw::wgmma_fence();
        MMA_S::ss_first(sc, fw::kmajor_desc(q_t, L::kQBox, 0),
                        fw::kmajor_desc(k_s, L::kKvBox, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
            MMA_S::ss(sc, fw::kmajor_desc(q_t, L::kQBox, kk),
                      fw::kmajor_desc(k_s, L::kKvBox, kk));
        fw::wgmma_commit();
        fw::mbar_wait(bar.v(s), parity);
        fw::wgmma_fence();
        MMA_S::ss_first(dp, fw::kmajor_desc(do_t, L::kQBox, 0),
                        fw::kmajor_desc(v_s, L::kKvBox, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
            MMA_S::ss(dp, fw::kmajor_desc(do_t, L::kQBox, kk),
                      fw::kmajor_desc(v_s, L::kKvBox, kk));
        fw::wgmma_commit();

        // ---- P = exp2(s^2 log2(e) S - lse log2(e)) while dP runs, then
        // dS = P (dP - delta); element c of a tile is row g + 8 (c >> 1)
        fw::wgmma_wait<1>();
        fw::fence_regs(sc);
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                sc[j][c] = fw::exp2_ftz(fmaf(sc[j][c], p.logit_scale,
                                             -lse2[c >> 1]));
        fw::wgmma_wait<0>();
        fw::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                dp[j][c] = sc[j][c] * (dp[j][c] - dlt[c >> 1]);

        // ---- dS as hi and lo bf16 A fragments, 16 keys a step
        uint32_t a_hi[KT / 2][4], a_lo[KT / 2][4];
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
            fw::split_step(dp, i, a_hi[i], a_lo[i]);

        // ---- dQ += dS K over this tile's keys, in partials of kPnKeys (K
        // read MN-major from the tile that fed S)
        fw::add_partials_bf16<BK, L::kBoxes>(acc, a_hi, a_lo, k_s,
                                             L::kKvBox);
        __syncwarp();
        if (lane == 0) fw::mbar_arrive(bar.empty(s));
    }

    T* dq_g = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh
        + static_cast<long long>(row0) * p.dq_st;
    flash_mma::store_rows<T, DT>(dq_g, p.dq_st, acc, p.grad_scale,
                                 p.grad_scale, lane);
}

template <typename T, int D, int BK, int STAGES>
__global__ void __launch_bounds__(flash_wgmma::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const BwdParams p) {
    static_assert(sizeof(T) == 2, "the wgmma route takes bfloat16");
    using L = DqWgmmaLayout<D, BK, STAGES>;
    namespace fw = flash_wgmma;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = smem_addr(fw::align_1024(smem_raw));
    const fw::KvRing<STAGES> bar{base + L::kBar};
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * L::kBQ;
    const int n_tiles = p.t / BK;

    if (threadIdx.x == 0) {
        fw::mbar_init(bar.once(), 1);
        for (int s = 0; s < STAGES; ++s) {
            fw::mbar_init(bar.k(s), 1);
            fw::mbar_init(bar.v(s), 1);
            fw::mbar_init(bar.empty(s), 8);  // every warp
        }
        fw::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // Q and dO, and the first STAGES key tiles
        const int h = bh % p.heads;
        const int b = bh / p.heads;
        fw::mbar_expect_tx(bar.once(), 2 * L::kBQ * D * 2);
        for (int box = 0; box < L::kBoxes; ++box) {
            fw::tma_load(base + L::kQ + box * L::kQBox, &tm_q, bar.once(),
                         box * fw::kBoxCols, q0, h, b);
            fw::tma_load(base + L::kDo + box * L::kQBox, &tm_do, bar.once(),
                         box * fw::kBoxCols, q0, h, b);
        }
        for (int tile = 0; tile < STAGES && tile < n_tiles; ++tile)
            fw::load_kv_tile<D, BK, STAGES>(&tm_k, &tm_v, base + L::kK,
                                            base + L::kV, bar, tile, h, b);
    }
    dq_consume<T, D, BK, STAGES>(p, &tm_k, &tm_v, base, bar, bh, q0,
                                 threadIdx.x >> 7, n_tiles);
}

// --------------------------------------------------- dQ: wgmma, float32
// float32 at D = 64 (the CLI default's Palette training shape) as 3xTF32
// on wgmma m64nNk8, replacing _bwd_dq_kernel (pallas_call at :290) there:
// the bf16 route's block (two warpgroups of 64 query rows; lse and delta of
// a thread's rows and its D/2 floats of dQ in registers for the whole loop)
// and the float32 forward's slot ring (flash_attention.cu), every operand a
// pair of TF32 hi and lo tiles from the split pass's planes, written once
// per backward call for both kernels (flash_split.cu): Q, dO, K and V
// K-major, and K^T (D rows of keys, each 8 permuted to match dS's
// accumulator fragment) for the product that sums over keys. Thread 0
// loads Q and dO hi and lo once, then the key tiles' groups in turn: K
// (hi, lo) of tile i as group 3i, V as 3i + 1, K^T as 3i + 2, group n into
// slot n % SLOTS of a ring whose slots each hold one group; a slot is
// `full` once its bytes have landed and `empty` once every warp is done
// with it (one arrival per warp). Per key tile a warpgroup
//   * issues S = Q K^T and dP = dO V^T as two groups of 3 D/8 SS wgmmas,
//     BK wide (lo x hi, hi x lo, hi x hi), both in flight at once;
//   * forms P = exp2(s^2 log2(e) S - lse log2(e)) in S's accumulators while
//     dP's wgmmas run, then releases K's and V's slots and forms
//     dS = P (dP - delta) in dP's;
//   * splits dS into TF32 hi (in place) and lo (into P's registers) and
//     adds dS K into dQ in partials of 32 keys per 64 columns of dQ, each
//     12 RS wgmmas (dS from registers as the A operand, K^T as B), two in
//     flight (add_partials_tf32), releasing K^T's slot.
// At the start of each tile thread 0 loads this tile's groups (waiting, if
// need be, for their slots) and every later group whose slot every warp has
// released; it issues nothing in the middle of a tile (code that only
// thread 0 runs among the wgmmas made ptxas serialise them, C7520, in the
// float32 forward and dkv), and the warpgroup index reaches the consumers
// through __shfl_sync for the same reason.
// A block is WGS warpgroups of 64 query rows (2 at D = 64).
// What bounds it: shared memory, and the CUDA-core work between a
// warpgroup's products (the exponential, dS, the split, the partial adds),
// which the other warpgroup's wgmmas overlap. Q and dO hi and lo take
// 128 KB for 128 rows and each key 1.5 KB (K, V and K^T, hi and lo), so 64
// keys of slots in all: (BK, SLOTS) = (64, 3) at D = 64, 178 registers, one
// tile's groups, each refilled at the next tile's start. Tried and dropped
// (tools/flash_f32_tiles.py; PERF.md): (32, 6), a tile ahead but 32 keys
// wide, 1.5x the time; Q hi and lo held in registers as the A operand of S
// (RS), which frees 64 KB for 4 or 5 slots, 2-3% faster at 244 registers a
// thread. At D = 128 Q and dO alone would take 256 KB for 128 rows: a block
// of one warpgroup (WGS = 1, (32, 3)), what fits, took 1.3x the time of the
// mma.sync kernel, which D = 128 keeps.
template <int D, int BK, int SLOTS, int WGS> struct DqTf32Layout {
    static constexpr int kBQ = 64 * WGS;
    static constexpr int kQBox = kBQ * flash_wgmma::kRowBytes;  // bytes
    static constexpr int kQPlane = kBQ * D * 4;
    static constexpr int kKBox = BK * flash_wgmma::kRowBytes;  // BK rows
    static constexpr int kTBox = D * flash_wgmma::kRowBytes;   // 32 keys
    static constexpr int kPlane = BK * D * 4;  // K hi (K lo, V .., K^T ..)
    static constexpr int kSlot = 2 * kPlane;   // hi and lo
    static constexpr int kQ = 0;               // Q hi, Q lo, dO hi, dO lo
    static constexpr int kDo = 2 * kQPlane;
    static constexpr int kSlots = 4 * kQPlane;
    static constexpr int kBar = kSlots + SLOTS * kSlot;
    // barriers: Q and dO, then full and empty of each slot
    static constexpr int kBytes = kBar + 8 * (1 + 2 * SLOTS) + 1024;
    static_assert(kBytes <= 232448, "shared memory of one block");
    static_assert(BK % 32 == 0 && SLOTS >= 3, "a tile's three groups");
};

// Thread 0's loads into the slot ring: group `next` on, those whose slot
// every warp has released; it waits for a slot only while `next <= need`.
template <int D, int BK, int SLOTS, int WGS>
__device__ __forceinline__ void dq_tf32_produce(const BwdTf32Maps& maps,
                                                uint32_t base,
                                                flash_wgmma::SlotRing<SLOTS>
                                                    bar,
                                                int& next, int groups,
                                                int need, int h, int b) {
    using L = DqTf32Layout<D, BK, SLOTS, WGS>;
    namespace fw = flash_wgmma;
    for (; next < groups; ++next) {
        const int s = next % SLOTS;
        if (next >= SLOTS) {
            const uint32_t parity = ((next / SLOTS) - 1) & 1;
            if (next <= need)
                fw::mbar_wait(bar.empty(s), parity);
            else if (!fw::mbar_try_wait(bar.empty(s), parity))
                return;
        }
        const uint32_t dst = base + L::kSlots + s * L::kSlot;
        const int tile = next / 3;
        const int kind = next % 3;  // 0 K, 1 V, 2 K^T
        fw::mbar_expect_tx(bar.full(s), L::kSlot);
        for (int plane = 0; plane < 2; ++plane) {
            if (kind < 2) {  // K or V: D/32 boxes of BK rows
                const CUtensorMap* m =
                    &maps.m[(kind == 0 ? kPlaneK : kPlaneV) + plane];
                for (int box = 0; box < D / fw::kTf32BoxCols; ++box)
                    fw::tma_load(dst + plane * L::kPlane + box * L::kKBox, m,
                                 bar.full(s), box * fw::kTf32BoxCols,
                                 tile * BK, h, b);
            } else {  // K^T: BK/32 boxes of D rows
                for (int box = 0; box < BK / fw::kTf32BoxCols; ++box)
                    fw::tma_load(dst + plane * L::kPlane + box * L::kTBox,
                                 &maps.m[kPlaneKt + plane], bar.full(s),
                                 tile * BK + box * fw::kTf32BoxCols, 0, h,
                                 b);
            }
        }
    }
}

// A warpgroup: query rows 64 cw .. 64 cw + 63 of the tile.
template <typename T, int D, int BK, int SLOTS, int WGS>
__device__ __forceinline__ void dq_consume_tf32(const BwdParams& p,
                                                const BwdTf32Maps& maps,
                                                uint32_t base,
                                                flash_wgmma::SlotRing<SLOTS>
                                                    bar,
                                                int bh, int q0, int cw,
                                                int n_tiles) {
    using L = DqTf32Layout<D, BK, SLOTS, WGS>;
    namespace fw = flash_wgmma;
    constexpr int KT = BK / 8;   // 8-column tiles of S and dP (keys)
    constexpr int DT = D / 8;    // 8-column tiles of dQ
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const bool producer = threadIdx.x == 0;
    const int groups = 3 * n_tiles;
    int next = SLOTS < groups ? SLOTS : groups;  // loaded before the loop
    const int row0 = q0 + 64 * cw + 16 * warp;  // the warp's first query row
    const uint32_t q_s = base + L::kQ + cw * 64 * fw::kRowBytes;
    const uint32_t do_s = base + L::kDo + cw * 64 * fw::kRowBytes;

    // lse (in log2 units) and delta of this thread's rows g and g + 8
    const long long row = static_cast<long long>(bh) * p.t + row0
        + (lane >> 2);
    const float lse2[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
    const float dlt[2] = {p.delta[row], p.delta[row + 8]};

    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    fw::mbar_wait(bar.once(), 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int nk = 3 * tile;  // K's group; V's is nk + 1, K^T's nk + 2
        const int ks = nk % SLOTS;
        const int vs = (nk + 1) % SLOTS;
        const int ts = (nk + 2) % SLOTS;
        const uint32_t k_t = base + L::kSlots + ks * L::kSlot;
        const uint32_t v_t = base + L::kSlots + vs * L::kSlot;
        const uint32_t kt_t = base + L::kSlots + ts * L::kSlot;
        if (producer)  // this tile's groups, and what slots are free
            dq_tf32_produce<D, BK, SLOTS, WGS>(maps, base, bar, next, groups,
                                               nk + 2, h, b);

        // ---- S = Q K^T and dP = dO V^T, 3xTF32: rows queries, columns
        // keys; two groups in flight
        float sc[KT][4], dp[KT][4];
        fw::mbar_wait(bar.full(ks), (nk / SLOTS) & 1);
        fw::wgmma_fence();
        fw::ss_3xtf32<BK, D>(sc, fw::opaque(q_s), L::kQBox, L::kQPlane, k_t,
                             L::kKBox, L::kPlane);
        fw::wgmma_commit();
        fw::mbar_wait(bar.full(vs), ((nk + 1) / SLOTS) & 1);
        fw::wgmma_fence();
        fw::ss_3xtf32<BK, D>(dp, fw::opaque(do_s), L::kQBox, L::kQPlane,
                             v_t, L::kKBox, L::kPlane);
        fw::wgmma_commit();

        // ---- P = exp2(s^2 log2(e) S - lse log2(e)) while dP runs, then
        // dS = P (dP - delta); element c of a tile is row g + 8 (c >> 1)
        fw::wgmma_wait<1>();
        fw::fence_regs(sc);
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                sc[j][c] = fw::exp2_ftz(fmaf(sc[j][c], p.logit_scale,
                                             -lse2[c >> 1]));
        fw::wgmma_wait<0>();
        fw::fence_regs(dp);
        __syncwarp();
        if (lane == 0) {
            fw::mbar_arrive(bar.empty(ks));
            fw::mbar_arrive(bar.empty(vs));
        }
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                dp[j][c] = sc[j][c] * (dp[j][c] - dlt[c >> 1]);

        // ---- dS as TF32 hi (in place) and lo (in P's registers), then
        // dQ += dS K over this tile's keys, in partials of kPnKeys
        fw::split_tf32_tiles(dp, dp, sc);
        fw::mbar_wait(bar.full(ts), ((nk + 2) / SLOTS) & 1);
        fw::add_partials_tf32<BK, D / 64, fw::kRowBytes>(
            acc, dp, sc, kt_t, kt_t + L::kPlane, L::kTBox);
        __syncwarp();
        if (lane == 0) fw::mbar_arrive(bar.empty(ts));
    }

    T* dq_g = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh
        + static_cast<long long>(row0) * p.dq_st;
    flash_mma::store_rows<T, DT>(dq_g, p.dq_st, acc, p.grad_scale,
                                 p.grad_scale, lane);
}

template <typename T, int D, int BK, int SLOTS, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdTf32Maps maps,
                          const BwdParams p) {
    static_assert(sizeof(T) == 4, "the float32 wgmma route");
    using L = DqTf32Layout<D, BK, SLOTS, WGS>;
    namespace fw = flash_wgmma;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = smem_addr(fw::align_1024(smem_raw));
    const fw::SlotRing<SLOTS> bar{base + L::kBar};
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * L::kBQ;
    const int n_tiles = p.t / BK;

    if (threadIdx.x == 0) {
        fw::mbar_init(bar.once(), 1);
        for (int s = 0; s < SLOTS; ++s) {
            fw::mbar_init(bar.full(s), 1);
            fw::mbar_init(bar.empty(s), 4 * WGS);  // every warp
        }
        fw::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // Q and dO hi and lo, and the first groups
        const int h = bh % p.heads;
        const int b = bh / p.heads;
        fw::mbar_expect_tx(bar.once(), 4 * L::kQPlane);
        for (int plane = 0; plane < 4; ++plane)
            for (int box = 0; box < D / fw::kTf32BoxCols; ++box)
                fw::tma_load(base + L::kQ + plane * L::kQPlane
                                 + box * L::kQBox,
                             &maps.m[plane < 2 ? kPlaneQ + plane
                                               : kPlaneDo + plane - 2],
                             bar.once(), box * fw::kTf32BoxCols, q0, h, b);
        int next = 0;
        dq_tf32_produce<D, BK, SLOTS, WGS>(maps, base, bar, next,
                                           3 * n_tiles, SLOTS - 1, h, b);
    }
    dq_consume_tf32<T, D, BK, SLOTS, WGS>(
        p, maps, base, bar, bh, q0,
        __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), n_tiles);
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

template <int D, int BQ, int STAGES>
cudaError_t launch_dkv_wgmma(const BwdParams& p, int batch,
                             cudaStream_t stream) {
    using L = DkvWgmmaLayout<D, BQ, STAGES>;
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    cudaError_t err = flash_wgmma::encode_operand(
        &tm_q, p.q, batch, p.heads, p.t, D, p.q_sb, p.q_sh, p.q_st, BQ);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_k, p.k, batch, p.heads, p.t, D,
                                          p.k_sb, p.k_sh, p.k_st, L::kBK);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_v, p.v, batch, p.heads, p.t, D,
                                          p.v_sb, p.v_sh, p.v_st, L::kBK);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_do, p.dout, batch, p.heads, p.t,
                                          D, p.do_sb, p.do_sh, p.do_st, BQ);
    if (err != cudaSuccess) return err;
    void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                   const CUtensorMap, const BwdParams) =
        flash_bwd_dkv_wgmma_kernel<__nv_bfloat16, D, BQ, STAGES>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / L::kBK, batch * p.heads);
    kernel<<<grid, flash_wgmma::kThreads, L::kBytes, stream>>>(
        tm_q, tm_k, tm_v, tm_do, p);
    return cudaGetLastError();
}

// The tensor maps of the planes in `reads` (bit i: plane i) of the split
// pass's fourteen (B, H, T, D) float32 planes at `planes`, in the order of
// BwdTf32Maps: K-major ones in boxes of 32 columns and `q_rows` (Q, dO) or
// `k_rows` (K, V) rows, transposed ones (D rows of T) in boxes of `t_cols`
// columns and D rows. The maps of other planes are zero.
cudaError_t encode_planes(BwdTf32Maps* maps, const float* planes,
                          unsigned reads, const BwdParams& p, int batch,
                          int d, int q_rows, int k_rows, int t_cols) {
    namespace fw = flash_wgmma;
    if (planes == nullptr) return cudaErrorInvalidValue;
    memset(maps, 0, sizeof(*maps));
    const long long n = static_cast<long long>(batch) * p.heads * p.t * d;
    for (int i = 0; i < kPlanes; ++i) {
        if (!((reads >> i) & 1)) continue;
        const int op = i & ~1;  // the plane's hi
        const bool transposed = op == kPlaneQt || op == kPlaneKt
            || op == kPlaneDot;  // (B, H, D, T)
        const bool keys = op == kPlaneK || op == kPlaneV;
        const cudaError_t err = transposed
            ? fw::encode_plane(&maps->m[i], planes + i * n, batch, p.heads,
                               d, p.t, t_cols, d)
            : fw::encode_plane(&maps->m[i], planes + i * n, batch, p.heads,
                               p.t, d, fw::kTf32BoxCols,
                               keys ? k_rows : q_rows);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

// The planes each float32 wgmma kernel reads (bit i: plane i): dkv all but
// K^T; dq Q, K, K^T, V and dO.
constexpr unsigned kDkvReads = 0x3fffu & ~(3u << kPlaneKt);
constexpr unsigned kDqReads = (3u << kPlaneQ) | (3u << kPlaneK)
    | (3u << kPlaneKt) | (3u << kPlaneV) | (3u << kPlaneDo);

template <int D, int BQ, int S1, int S2>
cudaError_t launch_dkv_wgmma_tf32(const BwdParams& p, const float* planes,
                                  int batch, cudaStream_t stream) {
    using L = DkvTf32Layout<D, BQ, S1, S2>;
    BwdTf32Maps maps;
    cudaError_t err = encode_planes(&maps, planes, kDkvReads, p, batch, D,
                                    BQ, L::kBK, L::kTBoxCols);
    if (err != cudaSuccess) return err;
    void (*kernel)(const BwdTf32Maps, const BwdParams) =
        flash_bwd_dkv_wgmma_kernel<float, D, BQ, S1, S2>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / L::kBK, batch * p.heads);
    kernel<<<grid, flash_wgmma::kThreads, L::kBytes, stream>>>(maps, p);
    return cudaGetLastError();
}

template <int D, int BK, int SLOTS, int WGS>
cudaError_t launch_dq_wgmma_tf32(const BwdParams& p, const float* planes,
                                 int batch, cudaStream_t stream) {
    using L = DqTf32Layout<D, BK, SLOTS, WGS>;
    BwdTf32Maps maps;
    cudaError_t err = encode_planes(&maps, planes, kDqReads, p, batch, D,
                                    L::kBQ, BK, flash_wgmma::kTf32BoxCols);
    if (err != cudaSuccess) return err;
    void (*kernel)(const BwdTf32Maps, const BwdParams) =
        flash_bwd_dq_wgmma_kernel<float, D, BK, SLOTS, WGS>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / L::kBQ, batch * p.heads);
    kernel<<<grid, 128 * WGS, L::kBytes, stream>>>(maps, p);
    return cudaGetLastError();
}

template <int D, int BK, int STAGES>
cudaError_t launch_dq_wgmma(const BwdParams& p, int batch,
                            cudaStream_t stream) {
    using L = DqWgmmaLayout<D, BK, STAGES>;
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    cudaError_t err = flash_wgmma::encode_operand(
        &tm_q, p.q, batch, p.heads, p.t, D, p.q_sb, p.q_sh, p.q_st, L::kBQ);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_k, p.k, batch, p.heads, p.t, D,
                                          p.k_sb, p.k_sh, p.k_st, BK);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_v, p.v, batch, p.heads, p.t, D,
                                          p.v_sb, p.v_sh, p.v_st, BK);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_do, p.dout, batch, p.heads, p.t,
                                          D, p.do_sb, p.do_sh, p.do_st,
                                          L::kBQ);
    if (err != cudaSuccess) return err;
    auto kernel = flash_bwd_dq_wgmma_kernel<__nv_bfloat16, D, BK, STAGES>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / L::kBQ, batch * p.heads);
    kernel<<<grid, flash_wgmma::kThreads, L::kBytes, stream>>>(
        tm_q, tm_k, tm_v, tm_do, p);
    return cudaGetLastError();
}

// Tiles, chosen so that ptxas spills nothing up to D = 128. dq (BQ queries
// x BK keys; a thread holds dQ, D/2 registers, S and dP, BK/2 each, and the
// products' fragments): float32 128 queries (8 warps) and 64-key tiles at
// D = 32, 32-key tiles at D = 128 (Q, dO and the K/V ring then take 198 KB);
// bfloat16 the same at D = 32, and at D = 256 64 queries and 16-key tiles
// (float32: 195 KB). dq on wgmma (bfloat16 at D = 64 and 128; 128 queries,
// BK keys, STAGES): (128, 3) at D = 64, (64, 3) at D = 128. dkv on mma.sync
// (output columns DO, BK keys x BQ queries; a thread holds dK and dV, D/2
// registers each, S^T and dP^T, BQ/2 each): 128 keys (8 warps) and 32-query
// tiles at D = 32; at D = 256 two column halves of 128, 64 keys and
// 16-query tiles (the float32 K, V and the Q/dO ring take 195 KB). dkv on
// wgmma, bfloat16 (64 keys, BQ queries, STAGES): (128, 3) at D = 64,
// (64, 4) at D = 128; larger query tiles spill at D = 128, and 64-query
// tiles ran slower at D = 64. dkv on wgmma, float32 (64 keys, BQ queries,
// S1, S2): (64, 1, 1) at D = 64, (16, 1, 1) at D = 128, what shared memory
// holds (the kernel's note). dq on wgmma, float32 (BK keys, SLOTS, WGS
// warpgroups of 64 query rows): (64, 3, 2) at D = 64 (the kernel's note).
template <typename T>
cudaError_t launch_for_d(const BwdParams& p, const float* planes, int batch,
                         int d, bool dkv, cudaStream_t stream) {
    constexpr bool kBf16 = sizeof(T) == 2;
    if (dkv) {
        switch (d) {
            case 32: return launch_dkv<T, 32, 32, 128, 64>(p, batch, stream);
            case 64:
                if constexpr (kBf16)
                    return launch_dkv_wgmma<64, 128, 3>(p, batch, stream);
                else
                    return launch_dkv_wgmma_tf32<64, 64, 1, 1>(p, planes,
                                                               batch, stream);
            case 128:
                if constexpr (kBf16)
                    return launch_dkv_wgmma<128, 64, 4>(p, batch, stream);
                else
                    return launch_dkv_wgmma_tf32<128, 16, 1, 1>(p, planes,
                                                                batch, stream);
            case 256:
                return launch_dkv<T, 256, 128, 64, 16>(p, batch, stream);
            default: return cudaErrorInvalidValue;
        }
    }
    switch (d) {
        case 32: return launch_dq<T, 32, 128, 64>(p, batch, stream);
        case 64:
            if constexpr (kBf16)
                return launch_dq_wgmma<64, 128, 3>(p, batch, stream);
            else
                return launch_dq_wgmma_tf32<64, 64, 3, 2>(p, planes, batch,
                                                          stream);
        case 128:
            if constexpr (kBf16)
                return launch_dq_wgmma<128, 64, 3>(p, batch, stream);
            else
                return launch_dq<T, 128, 128, 32>(p, batch, stream);
        case 256: return launch_dq<T, 256, 64, 16>(p, batch, stream);
        default: return cudaErrorInvalidValue;
    }
}

int launch(bool dkv, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, int batch, int heads, int t, int d, int dtype,
           const long long* s, const float* planes, void* stream) {
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
        err = launch_for_d<float>(p, planes, batch, d, dkv, st);
    else if (dtype == 1)
        err = launch_for_d<__nv_bfloat16>(p, planes, batch, d, dkv, st);
    else
        err = cudaErrorInvalidValue;
    return static_cast<int>(err);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; q, k, v, dout (and dq, dk, dv) of that type,
// lse and delta float32 (B*H, T) contiguous. t must be a multiple of 128.
// `strides` holds 21 element strides, (batch, head, row) of q, k, v, dout,
// dq, dk, dv in that order; the last dimension of each is contiguous.
// `planes`: for float32 at d = 64 and 128 the split pass's planes of q and
// k (K-major and transposed), v (K-major) and dout (both),
// (14, batch, heads, t, d) (pai_flash_split, one call's planes for both
// entries), which the wgmma routes read instead of q, k, v and dout
// (dkv at d = 64 and 128, dq at d = 64); ignored otherwise. Each entry
// launches one kernel on `stream`, does not synchronise, allocates nothing,
// and returns the CUDA error code.
extern "C" int pai_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int batch, int heads, int t, int d, int dtype, const long long* strides,
    const float* planes, void* stream) {
    return launch(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                  batch, heads, t, d, dtype, strides, planes, stream);
}

extern "C" int pai_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int batch, int heads, int t, int d, int dtype, const long long* strides,
    const float* planes, void* stream) {
    return launch(true, q, k, v, dout, lse, delta, nullptr, dk, dv,
                  batch, heads, t, d, dtype, strides, planes, stream);
}

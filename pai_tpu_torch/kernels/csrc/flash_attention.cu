// Flash-attention forward for Hopper (sm_90a) on the tensor cores.
//
// Replaces the TPU kernel pai_tpu/kernels/flash_attention.py::_fwd_kernel
// (pallas_call at :148, called through _fwd_call; both instantiations, with
// and without the per-row log-sum-exp). Non-causal, unmasked multi-head
// attention over (B, H, T, D):
//
//     o = softmax((q * D^-1/4) (k * D^-1/4)^T) v,  lse = logsumexp of logits
//
// with float32 logits, softmax and accumulator whatever the element type;
// operands are float or bfloat16, the output is written in the operands' type.
//
// What bounds it on an H100: operations. 4*B*H*T^2*D floating-point operations
// against 4*B*H*T*D elements moved, i.e. T operations per element. So both
// products run on the tensor cores, by one of two routes that launch_for_d
// fixes by (dtype, D):
//
// * wgmma (bfloat16 at D = 64 and D = 128, flash_fwd_wgmma_kernel, the
//   bf16-mixed Palette path's shapes): Hopper's warpgroup products with TMA
//   tile loads (flash_wgmma.cuh). P enters P V as two bf16 terms from
//   registers; its design is described above the kernel.
// * mma.sync (everything else, flash_fwd_kernel): warp-level products
//   (flash_mma.cuh), bfloat16 operands as bf16 m16n8k16 (P as two bf16
//   terms), float32 operands as 3xTF32 m16n8k8, which keeps float32
//   accuracy at up to a third of the TF32 rate (165 TFLOP/s against the
//   CUDA cores' 67). wgmma takes TF32 operands only K-major, so a 3xTF32
//   P V there would need V transposed and split into hi and lo in shared
//   memory on every tile: not done yet.
//
// The mma.sync route:
// * One block owns one (batch*head, BQ-row query tile) and loops over BK-row
//   K/V tiles; each of its BQ/16 warps owns 16 query rows (FlashAttention-2).
// * S = Q K^T stays in the mma accumulator fragments. The online softmax runs
//   in registers: a thread holds BK/4 of a row's logits, the row's max and
//   sum come from the four threads of a quad by shuffles. The scale
//   D^-1/2 * log2(e) is applied to S in float32 after the product (operands
//   are not pre-scaled, which would round a bf16 Q); the exponential is
//   exp2f; lse is converted back to natural-log units at the end.
// * P's accumulator fragments become the A operand of O += P V in registers
//   (no round trip through shared memory; see flash_mma.cuh for the TF32
//   k-permutation). The running maximum m, the denominator l and the D-wide
//   accumulator stay in registers from the first tile to the last; P V adds
//   into the accumulator in partial sums of 32 keys, because the tensor
//   cores' own accumulation truncates (flash_mma.cuh).
// * m starts at -inf: the first tile gives alpha = exp2(-inf - m_new) = 0
//   and never exp2(-inf - -inf).
// * K and V tiles arrive by cp.async in the operands' own type (bf16 tiles
//   take half the shared memory of float ones) into a ring of two stages:
//   tile i + 1 is in flight while tile i is multiplied. Q is copied once.
//   float32 values are split into TF32 hi/lo as fragments are loaded: each
//   A fragment once per tile and warp, each B fragment once per warp (split
//   once per tile into (hi, lo) pairs in shared memory instead, the kernel
//   was slower: the saved conversions came back as moves into the mma
//   operand registers, plus a pass and a barrier per tile; PERF.md).
// * Tiles per D (BQ x BK; threads 2 BQ): 128 x 64 up to D = 128; at D = 256
//   64 x 32 for float32 (its Q tile and K/V ring need 200 KB) and 64 x 16
//   for bfloat16. One block per SM: with two, D = 64 spills. Up to D = 128
//   ptxas spills nothing; at D = 256, where the accumulator alone takes 128
//   of a thread's 255 registers, both instantiations spill (PERF.md).
//
// Both routes: q, k, v and o are addressed by element strides for batch, head
// and row (the last dimension is contiguous; the other strides are multiples
// of 16 bytes), so views of one packed (N, T, heads, 3, D) tensor are read in
// place and o can be written token-major. No atomics and a fixed order of
// accumulation: the result is bit-reproducible. Shared memory is dynamic, so
// every instantiation is given cudaFuncAttributeMaxDynamicSharedMemorySize
// before it is launched. Plain C interface; the entry returns the CUDA error
// code (a tensor map the driver refuses is cudaErrorInvalidValue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"
#include "flash_wgmma.cuh"

namespace {

using flash_mma::Warp;
using flash_mma::smem_addr;

struct FlashParams {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;  // (B*H, T) or nullptr
    int heads;
    int t;
    long long q_sb, q_sh, q_st;
    long long k_sb, k_sh, k_st;
    long long v_sb, v_sh, v_st;
    long long o_sb, o_sh, o_st;
    float logit_scale;  // D^-1/2 * log2(e)
};

// One key tile's online-softmax step on a warp's 16 rows (the wgmma route):
// S (KT column tiles of C fragments, element c of a tile is row
// g + 8 (c >> 1)) becomes P = exp2(scale S - m_new) in place; the running
// maximum (log2 units), the thread's partial denominators and the
// accumulator are rescaled by alpha = exp2(m_old - m_new). The same function
// as the mma.sync route's in fewer instructions: the row maximum is taken
// over the raw products (the scale is positive, so it commutes with the
// maximum and its rounding), and each probability is exp2(fma(s, scale, -m))
// by the special function unit, one FFMA and one MUFU an element. Row maxima
// come from the four threads of a quad by shuffles; the quad's partial sums
// are added once, after the last tile.
template <int KT, int DT>
__device__ __forceinline__ void online_softmax_fma(float (&s)[KT][4],
                                                   float (&m_run)[2],
                                                   float (&l_run)[2],
                                                   float (&acc)[DT][4],
                                                   float logit_scale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KT; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * logit_scale);
        const float alpha = flash_wgmma::exp2_ftz(m_run[r] - m_new);
        m_run[r] = m_new;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            s[j][2 * r] = flash_wgmma::exp2_ftz(
                fmaf(s[j][2 * r], logit_scale, -m_new));
            s[j][2 * r + 1] = flash_wgmma::exp2_ftz(
                fmaf(s[j][2 * r + 1], logit_scale, -m_new));
            part += s[j][2 * r] + s[j][2 * r + 1];
        }
        l_run[r] = l_run[r] * alpha + part;
#pragma unroll
        for (int i = 0; i < DT; ++i) {
            acc[i][2 * r] *= alpha;
            acc[i][2 * r + 1] *= alpha;
        }
    }
}

// o = acc / l and lse = m + log l (back in natural-log units) of a warp's 16
// rows starting at query row `row` of batch*head `bh` (the wgmma route).
template <typename T, int DT>
__device__ __forceinline__ void store_output(const FlashParams& p, int bh,
                                             int row,
                                             const float (&acc)[DT][4],
                                             const float (&m_run)[2],
                                             float (&l_run)[2], int lane) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        inv[r] = 1.0f / l_run[r];
    }
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    T* o_g = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh
        + static_cast<long long>(row) * p.o_st;
    flash_mma::store_rows<T, DT>(o_g, p.o_st, acc, inv[0], inv[1], lane);
    if (p.lse != nullptr && (lane & 3) == 0) {
        float* lse = p.lse + static_cast<long long>(bh) * p.t + row
            + (lane >> 2);
        lse[0] = (m_run[0] + log2f(l_run[0])) * flash_mma::kLn2;
        lse[8] = (m_run[1] + log2f(l_run[1])) * flash_mma::kLn2;
    }
}

template <typename T, int D, int BQ, int BK> struct Layout {
    static constexpr int kStride = D + Warp<T>::kPad;  // elements per row
    static constexpr int kQ = 0;
    static constexpr int kK = kQ + BQ * kStride;        // 2 stages
    static constexpr int kV = kK + 2 * BK * kStride;    // 2 stages
    static constexpr int kElems = kV + 2 * BK * kStride;
    static constexpr int kBytes = kElems * static_cast<int>(sizeof(T));
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ, 1)
flash_fwd_kernel(const FlashParams p) {
    using L = Layout<T, D, BQ, BK>;
    using W = Warp<T>;
    constexpr int NT = 2 * BQ;       // threads: BQ / 16 warps
    constexpr int S = L::kStride;
    constexpr int KT = BK / 8;       // 8-column tiles of S
    constexpr int DT = D / 8;        // 8-column tiles of O

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    T* q_s = smem + L::kQ;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bh = blockIdx.y;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int q0 = blockIdx.x * BQ;

    const T* q_g = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
        + static_cast<long long>(q0) * p.q_st;
    const T* k_g = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v_g = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

    flash_mma::copy_tile<T, BQ, D, S, NT>(q_s, q_g, p.q_st, tid);
    flash_mma::copy_tile<T, BK, D, S, NT>(smem + L::kK, k_g, p.k_st, tid);
    flash_mma::copy_tile<T, BK, D, S, NT>(smem + L::kV, v_g, p.v_st, tid);
    flash_mma::cp_async_commit();

    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
    float l_run[2] = {0.0f, 0.0f};            // this thread's partial sums
    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    const T* q_w = q_s + 16 * warp * S;
    const int n_tiles = p.t / BK;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int stage = tile & 1;
        if (tile + 1 < n_tiles) {
            const long long next = static_cast<long long>(tile + 1) * BK;
            T* k_next = smem + L::kK + (stage ^ 1) * BK * S;
            T* v_next = smem + L::kV + (stage ^ 1) * BK * S;
            flash_mma::copy_tile<T, BK, D, S, NT>(k_next, k_g + next * p.k_st,
                                                  p.k_st, tid);
            flash_mma::copy_tile<T, BK, D, S, NT>(v_next, v_g + next * p.v_st,
                                                  p.v_st, tid);
            flash_mma::cp_async_commit();
            flash_mma::cp_async_wait<1>();  // tile `tile` (and Q) landed
        } else {
            flash_mma::cp_async_wait<0>();
        }
        __syncthreads();
        const T* k_s = smem + L::kK + stage * BK * S;
        const T* v_s = smem + L::kV + stage * BK * S;

        // ---- S = Q K^T in the accumulator fragments, then log2 units
        float s[KT][4];
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
        W::template gemm_nt<KT, D, S>(s, q_w, k_s, lane);

        // ---- online softmax; element c of a tile is row g + 8 (c >> 1)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                s[j][2 * r] *= p.logit_scale;
                s[j][2 * r + 1] *= p.logit_scale;
                mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_run[r], mx);
            const float alpha = exp2f(m_run[r] - m_new);
            m_run[r] = m_new;
            float part = 0.0f;
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
                s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
                part += s[j][2 * r] + s[j][2 * r + 1];
            }
            // the quad's partial sums are added once, after the last tile
            // (alpha is the same in all four threads)
            l_run[r] = l_run[r] * alpha + part;
#pragma unroll
            for (int i = 0; i < DT; ++i) {
                acc[i][2 * r] *= alpha;
                acc[i][2 * r + 1] *= alpha;
            }
        }

        // ---- O += P V, P straight from the fragments
        W::template gemm_pn<KT, DT, S>(acc, s, v_s, lane);
        __syncthreads();  // everyone is done with this stage before the
                          // copy of tile + 2 is issued into it
    }

    // ---- o = acc / l, lse = m + log l (back in natural-log units)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        inv[r] = 1.0f / l_run[r];
    }
    const int row0 = 16 * warp;
    T* o_g = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh
        + static_cast<long long>(q0 + row0) * p.o_st;
    flash_mma::store_rows<T, DT>(o_g, p.o_st, acc, inv[0], inv[1], lane);
    if (p.lse != nullptr && (lane & 3) == 0) {
        float* lse = p.lse + static_cast<long long>(bh) * p.t + q0 + row0
            + (lane >> 2);
        lse[0] = (m_run[0] + log2f(l_run[0])) * flash_mma::kLn2;
        lse[8] = (m_run[1] + log2f(l_run[1])) * flash_mma::kLn2;
    }
}

// ------------------------------------------------------------ wgmma route
// bfloat16 at D = 64 and D = 128 (flash_wgmma.cuh). One block of two
// warpgroups owns one (batch*head, 128-row query tile), 64 query rows per
// warpgroup. Thread 0 loads Q once and K and V tiles (BK keys) into a ring of
// STAGES stages by TMA, each tile on its own `full` barrier; at the start of
// key tile i it refills the stage of tile i - 1 once that stage's `empty`
// barrier says both warpgroups are done with it. Per key tile a warpgroup
//   * waits for K and runs S = Q K^T as BK-wide SS wgmmas (Q and K from
//     shared memory, K-major, D/16 steps), float32 accumulators;
//   * takes the online-softmax step in registers (online_softmax_fma);
//   * turns P into hi and lo bf16 A fragments, waits for V and adds P V into
//     O in partials of 32 keys (kPnKeys) per 64-column box of V: each a fresh
//     float32 accumulator of four RS wgmmas (the two lo terms first, then the
//     two hi terms, V read transposed), added to O with an ordinary float32
//     add while the next partial runs (two in flight);
//   * arrives on the stage's `empty` barrier (one arrival per warp).
// What bounds it: besides the products (P V twice, for hi and lo), some ten
// CUDA-core instructions per element of S (softmax, split, partial adds),
// which one warpgroup does not overlap with its own wgmmas; the two
// warpgroups share the tensor cores. Tiles (BK, STAGES): D = 64 (128, 3),
// 212 registers; D = 128 (64, 3), 227 registers, where BK = 128 spills; no
// spill (PERF.md).
template <int D, int BK, int STAGES> struct WgmmaLayout {
    static constexpr int kBQ = 128;
    static constexpr int kBoxes = D / flash_wgmma::kBoxCols;
    static constexpr int kQBox = kBQ * flash_wgmma::kRowBytes;  // bytes
    static constexpr int kKvBox = BK * flash_wgmma::kRowBytes;
    static constexpr int kQ = 0;
    static constexpr int kK = kQ + kBoxes * kQBox;
    static constexpr int kV = kK + STAGES * kBoxes * kKvBox;
    static constexpr int kBar = kV + STAGES * kBoxes * kKvBox;
    // barriers: Q, then K full, V full and empty of each stage
    static constexpr int kBytes = kBar + 8 * (1 + 3 * STAGES) + 1024;
    static constexpr uint32_t kTileBytes = BK * D * 2;
};

// The ring's barriers: Q, then K full, V full and empty of each stage.
template <int STAGES> struct FwdBarriers {
    uint32_t base;
    __device__ uint32_t q() const { return base; }
    __device__ uint32_t k(int s) const { return base + 8 * (1 + s); }
    __device__ uint32_t v(int s) const { return base + 8 * (1 + STAGES + s); }
    __device__ uint32_t empty(int s) const {
        return base + 8 * (1 + 2 * STAGES + s);
    }
};

// K and V of key tile `tile` into its ring stage (thread 0 only).
template <int D, int BK, int STAGES>
__device__ __forceinline__ void fwd_load_tile(const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v,
                                              uint32_t base,
                                              FwdBarriers<STAGES> bar,
                                              int tile, int h, int b) {
    using L = WgmmaLayout<D, BK, STAGES>;
    namespace fw = flash_wgmma;
    const int s = tile % STAGES;
    const uint32_t k_s = base + L::kK + s * L::kBoxes * L::kKvBox;
    const uint32_t v_s = base + L::kV + s * L::kBoxes * L::kKvBox;
    fw::mbar_expect_tx(bar.k(s), L::kTileBytes);
    for (int box = 0; box < L::kBoxes; ++box)
        fw::tma_load(k_s + box * L::kKvBox, tm_k, bar.k(s),
                     box * fw::kBoxCols, tile * BK, h, b);
    fw::mbar_expect_tx(bar.v(s), L::kTileBytes);
    for (int box = 0; box < L::kBoxes; ++box)
        fw::tma_load(v_s + box * L::kKvBox, tm_v, bar.v(s),
                     box * fw::kBoxCols, tile * BK, h, b);
}

// A warpgroup: query rows 64 cw .. 64 cw + 63 of the tile.
template <typename T, int D, int BK, int STAGES>
__device__ __forceinline__ void fwd_consume(const FlashParams& p,
                                            const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v,
                                            uint32_t base,
                                            FwdBarriers<STAGES> bar, int bh,
                                            int q0, int cw, int n_tiles) {
    using L = WgmmaLayout<D, BK, STAGES>;
    using MMA_S = flash_wgmma::Wgmma<BK>;
    using MMA_O = flash_wgmma::Wgmma<flash_wgmma::kBoxCols>;
    namespace fw = flash_wgmma;
    constexpr int KT = BK / 8;   // 8-column tiles of S
    constexpr int DT = D / 8;    // 8-column tiles of O
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const uint32_t q_s = base + L::kQ + cw * 64 * fw::kRowBytes;

    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
    float l_run[2] = {0.0f, 0.0f};            // this thread's partial sums
    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

    fw::mbar_wait(bar.q(), 0);
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
            fwd_load_tile<D, BK, STAGES>(tm_k, tm_v, base, bar, refill,
                                         bh % p.heads, bh / p.heads);
        }

        // ---- S = Q K^T
        const uint32_t q_t = fw::opaque(q_s);
        float sc[KT][4];
        fw::mbar_wait(bar.k(s), parity);
        fw::wgmma_fence();
        MMA_S::ss_first(sc, fw::kmajor_desc(q_t, L::kQBox, 0),
                        fw::kmajor_desc(k_s, L::kKvBox, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
            MMA_S::ss(sc, fw::kmajor_desc(q_t, L::kQBox, kk),
                      fw::kmajor_desc(k_s, L::kKvBox, kk));
        fw::wgmma_commit();
        fw::wgmma_wait<0>();
        fw::fence_regs(sc);

        online_softmax_fma<KT, DT>(sc, m_run, l_run, acc, p.logit_scale);

        // ---- P as hi and lo bf16 A fragments, 16 keys a step
        uint32_t p_hi[KT / 2][4], p_lo[KT / 2][4];
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
            fw::split_step(sc, i, p_hi[i], p_lo[i]);

        // ---- O += P V: one partial of kPnKeys keys per 64-column box of V
        // (four RS wgmmas into a fresh accumulator), two partials in flight;
        // partial j is added to O once partial j + 1 has been issued
        fw::mbar_wait(bar.v(s), parity);
        constexpr int kSteps = flash_mma::kPnKeys / 16;
        constexpr int kJobs = BK / flash_mma::kPnKeys * L::kBoxes;
        float part[2][8][4];
#pragma unroll
        for (int j = 0; j <= kJobs; ++j) {
            if (j < kJobs) {
                const int x = j % L::kBoxes;
                const int k0 = kSteps * (j / L::kBoxes);
                fw::wgmma_fence();
                // the small terms first: the tensor cores truncate as they
                // accumulate, which costs a small term less while the
                // partial is small too
                MMA_O::rs_t_first(part[j & 1], p_lo[k0],
                                  fw::mnmajor_desc(v_s + x * L::kKvBox,
                                                   L::kKvBox, k0));
#pragma unroll
                for (int i = 1; i < kSteps; ++i)
                    MMA_O::rs_t(part[j & 1], p_lo[k0 + i],
                                fw::mnmajor_desc(v_s + x * L::kKvBox,
                                                 L::kKvBox, k0 + i));
#pragma unroll
                for (int i = 0; i < kSteps; ++i)
                    MMA_O::rs_t(part[j & 1], p_hi[k0 + i],
                                fw::mnmajor_desc(v_s + x * L::kKvBox,
                                                 L::kKvBox, k0 + i));
                fw::wgmma_commit();
            }
            if (j > 0) {
                if (j < kJobs)
                    fw::wgmma_wait<1>();
                else
                    fw::wgmma_wait<0>();
                const int x = (j - 1) % L::kBoxes;
                fw::fence_regs(part[(j - 1) & 1]);
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[8 * x + i][c] += part[(j - 1) & 1][i][c];
            }
        }
        __syncwarp();
        if (lane == 0) fw::mbar_arrive(bar.empty(s));
    }

    store_output<T, DT>(p, bh, q0 + 64 * cw + 16 * warp, acc, m_run, l_run,
                        lane);
}

template <typename T, int D, int BK, int STAGES>
__global__ void __launch_bounds__(flash_wgmma::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const FlashParams p) {
    static_assert(sizeof(T) == 2, "the wgmma route takes bfloat16");
    using L = WgmmaLayout<D, BK, STAGES>;
    namespace fw = flash_wgmma;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = smem_addr(fw::align_1024(smem_raw));
    const FwdBarriers<STAGES> bar{base + L::kBar};
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * L::kBQ;
    const int n_tiles = p.t / BK;

    if (threadIdx.x == 0) {
        fw::mbar_init(bar.q(), 1);
        for (int s = 0; s < STAGES; ++s) {
            fw::mbar_init(bar.k(s), 1);
            fw::mbar_init(bar.v(s), 1);
            fw::mbar_init(bar.empty(s), 8);  // every warp
        }
        fw::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // Q, and the first STAGES key tiles
        const int h = bh % p.heads;
        const int b = bh / p.heads;
        fw::mbar_expect_tx(bar.q(), L::kBQ * D * 2);
        for (int box = 0; box < L::kBoxes; ++box)
            fw::tma_load(base + L::kQ + box * L::kQBox, &tm_q, bar.q(),
                         box * fw::kBoxCols, q0, h, b);
        for (int tile = 0; tile < STAGES && tile < n_tiles; ++tile)
            fwd_load_tile<D, BK, STAGES>(&tm_k, &tm_v, base, bar, tile, h, b);
    }
    fwd_consume<T, D, BK, STAGES>(p, &tm_k, &tm_v, base, bar, bh, q0,
                                  threadIdx.x >> 7, n_tiles);
}

template <int D, int BK, int STAGES>
cudaError_t launch_wgmma(const FlashParams& p, int batch,
                         cudaStream_t stream) {
    using L = WgmmaLayout<D, BK, STAGES>;
    CUtensorMap tm_q, tm_k, tm_v;
    cudaError_t err = flash_wgmma::encode_operand(
        &tm_q, p.q, batch, p.heads, p.t, D, p.q_sb, p.q_sh, p.q_st, L::kBQ);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_k, p.k, batch, p.heads, p.t, D,
                                          p.k_sb, p.k_sh, p.k_st, BK);
    if (err == cudaSuccess)
        err = flash_wgmma::encode_operand(&tm_v, p.v, batch, p.heads, p.t, D,
                                          p.v_sb, p.v_sh, p.v_st, BK);
    if (err != cudaSuccess) return err;
    auto kernel = flash_fwd_wgmma_kernel<__nv_bfloat16, D, BK, STAGES>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / L::kBQ, batch * p.heads);
    kernel<<<grid, flash_wgmma::kThreads, L::kBytes, stream>>>(tm_q, tm_k,
                                                               tm_v, p);
    return cudaGetLastError();
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const FlashParams& p, int batch, cudaStream_t stream) {
    constexpr int kBytes = Layout<T, D, BQ, BK>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / BQ, batch * p.heads);
    flash_fwd_kernel<T, D, BQ, BK><<<grid, 2 * BQ, kBytes, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_d(const FlashParams& p, int batch, int d,
                         cudaStream_t stream) {
    constexpr bool kBf16 = sizeof(T) == 2;
    switch (d) {
        case 32: return launch<T, 32, 128, 64>(p, batch, stream);
        case 64:
            if constexpr (kBf16)
                return launch_wgmma<64, 128, 3>(p, batch, stream);
            else
                return launch<T, 64, 128, 64>(p, batch, stream);
        case 128:
            if constexpr (kBf16)
                return launch_wgmma<128, 64, 3>(p, batch, stream);
            else
                return launch<T, 128, 128, 64>(p, batch, stream);
        case 256:
            if constexpr (kBf16)
                return launch<T, 256, 64, 16>(p, batch, stream);
            else
                return launch<T, 256, 64, 32>(p, batch, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. t must be a multiple of 128, the query tile
// (64 at d = 256 divides it). Strides in elements, multiples of 16 bytes; the
// last dimension of q, k, v and o is contiguous. lse may be null. Launches on
// `stream`, does not synchronise, allocates nothing; returns the CUDA error
// code.
extern "C" int pai_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int heads, int t, int d, int dtype,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st, void* stream) {
    if (batch <= 0 || heads <= 0 || t <= 0 || t % 128 != 0 ||
        static_cast<long long>(batch) * heads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    FlashParams p;
    p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
    p.heads = heads; p.t = t;
    p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
    p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
    p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
    p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
    p.logit_scale = flash_mma::kLog2e / sqrtf(static_cast<float>(d));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0)
        err = launch_for_d<float>(p, batch, d, s);
    else if (dtype == 1)
        err = launch_for_d<__nv_bfloat16>(p, batch, d, s);
    else
        err = cudaErrorInvalidValue;
    return static_cast<int>(err);
}

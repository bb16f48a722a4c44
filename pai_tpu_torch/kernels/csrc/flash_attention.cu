// Flash-attention forward for Hopper (sm_90a), float32 FMAs on the CUDA cores.
//
// Replaces the TPU kernel pai_tpu/kernels/flash_attention.py::_fwd_kernel
// (called through _fwd_call; both instantiations, with and without the per-row
// log-sum-exp). Non-causal, unmasked multi-head attention over (B, H, T, D):
//
//     o = softmax((q * D^-1/4) (k * D^-1/4)^T) v,   lse = logsumexp of the logits
//
// with float32 logits, softmax and accumulator whatever the element type;
// operands are float or bfloat16 (converted to float as they are loaded), the
// output is written in the operands' type.
//
// What bounds it on an H100: operations. 4*B*H*T^2*D floating-point operations
// against 4*B*H*T*D elements moved, i.e. T operations per element: at T = 4096
// and up the 67 TFLOP/s of the CUDA cores are reached long before the
// 3.35 TB/s of the memory. The design therefore spends its effort on the two
// products' inner loops and keeps everything else out of them:
//
// * One block owns one (batch*head, 128-row query tile) and loops over the
//   64-row K/V tiles itself; the running maximum m, the denominator l and the
//   (rows x D) accumulator stay in registers from the first tile to the last.
//   (On the TPU the kv axis is a sequential grid dimension carrying that state
//   in scratch memory; Hopper blocks run in no order and share nothing.)
// * 256 threads as a 16 x 16 grid. Thread (ty, tx) owns query rows ty + 16*i
//   for both products, so the softmax statistics of a row live in the 16
//   lanes of one half-warp and the rescaling factor alpha is already in the
//   registers that hold the accumulator rows. Per step of 4 along the
//   reduction a thread issues 12-16 16-byte shared-memory loads for 128-256
//   FMAs.
// * Q (pre-multiplied by D^-1/2 * log2(e)), K and the probabilities P are
//   kept in shared memory with padded rows so that the 16-byte loads of a
//   quarter-warp fall into distinct banks. The exponential is exp2f with the
//   log2(e) folded into Q's scale; lse is converted back to natural log.
// * K and V tiles of float operands arrive by cp.async: V(i) is in flight
//   while S = QK^T of tile i is computed, K(i+1) while P V is. bfloat16
//   operands are converted on the way in and take the synchronous path.
// * m starts at -inf: the first tile gives alpha = exp2(-inf - m_new) = 0
//   and never exp2(-inf - -inf).
// * q, k, v and o are addressed by element strides for batch, head and row
//   (the last dimension is contiguous), so views of one packed
//   (N, T, heads, 3, D) tensor are read in place and o can be written
//   token-major. No atomics: the result is bit-reproducible.
//
// Shared memory is dynamic (up to 219,136 bytes at D = 256), so every
// instantiation is given cudaFuncAttributeMaxDynamicSharedMemorySize before
// it is launched. Plain C interface; the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockK = 64;       // K/V rows per tile
constexpr int kPStride = kBlockK + 16;  // row stride of P in floats

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
    float q_scale;  // D^-1/2 * log2(e)
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
// memory as floats (row stride SMEM_STRIDE floats), each thread 4 elements at
// a time, coalesced along D. Float operands go by cp.async.
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

template <int D, int BQ> struct Layout {
    static constexpr int kQStride = D + 4;   // Q and K rows, padded
    static constexpr int kQ = 0;
    static constexpr int kK = kQ + BQ * kQStride;
    static constexpr int kV = kK + kBlockK * kQStride;
    static constexpr int kP = kV + kBlockK * D;
    static constexpr int kFloats = kP + BQ * kPStride;
    static constexpr int kBytes = kFloats * 4;
};

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads, (D <= 64 ? 2 : 1))
flash_fwd_kernel(const FlashParams p) {
    using L = Layout<D, BQ>;
    constexpr int RQ = BQ / 16;            // query rows per thread
    constexpr int CK = kBlockK / 16;       // logits columns per thread
    constexpr int VW = (D >= 64) ? 4 : 2;  // output columns per vector
    constexpr int NV = D / 16 / VW;        // output vectors per thread
    constexpr int QS = L::kQStride;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* smem = reinterpret_cast<float*>(smem_raw);
    float* q_s = smem + L::kQ;
    float* k_s = smem + L::kK;
    float* v_s = smem + L::kV;
    float* p_s = smem + L::kP;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int q0 = blockIdx.x * BQ;

    const T* q_g = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
        + static_cast<long long>(q0) * p.q_st;
    const T* k_g = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v_g = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

    // K(0) goes out first so that it travels while Q is scaled and stored.
    load_tile<T, D, kBlockK, QS>(k_s, k_g, p.k_st, tid);
    {
        constexpr int kVecPerRow = D / 4;
#pragma unroll
        for (int it = 0; it < BQ * kVecPerRow / kThreads; ++it) {
            const int idx = tid + it * kThreads;
            const int r = idx / kVecPerRow;
            const int c = (idx % kVecPerRow) * 4;
            float4 x = Elem<T>::load4(q_g + r * p.q_st + c);
            x.x *= p.q_scale; x.y *= p.q_scale;
            x.z *= p.q_scale; x.w *= p.q_scale;
            *reinterpret_cast<float4*>(q_s + r * QS + c) = x;
        }
    }

    float m_run[RQ], l_run[RQ];
    float acc[RQ][NV][VW];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        m_run[i] = -INFINITY;
        l_run[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
            for (int c = 0; c < VW; ++c) acc[i][j][c] = 0.0f;
    }

    const int n_tiles = p.t / kBlockK;
    for (int tile = 0; tile < n_tiles; ++tile) {
        // K(tile) has landed; everyone is done with V and P of the last tile.
        cp_async_wait_all();
        __syncthreads();
        load_tile<T, D, kBlockK, D>(
            v_s, v_g + static_cast<long long>(tile) * kBlockK * p.v_st,
            p.v_st, tid);

        // ---- S = Q K^T (in log2 units), rows ty + 16 i, columns tx + 16 j
        float s[RQ][CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
            float4 kf[CK];
#pragma unroll
            for (int j = 0; j < CK; ++j)
                kf[j] = *reinterpret_cast<const float4*>(
                    k_s + (tx + 16 * j) * QS + d);
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const float4 qf = *reinterpret_cast<const float4*>(
                    q_s + (ty + 16 * i) * QS + d);
#pragma unroll
                for (int j = 0; j < CK; ++j) {
                    s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
                    s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
                    s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
                    s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
                }
            }
        }

        // ---- online softmax; a row's 64 logits sit in one half-warp
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            float mx = s[i][0];
#pragma unroll
            for (int j = 1; j < CK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_run[i], mx);
            const float alpha = exp2f(m_run[i] - m_new);
            m_run[i] = m_new;
            float part = 0.0f;
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                const float e = exp2f(s[i][j] - m_new);
                part += e;
                p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = e;
            }
            // per-thread partial denominator; the 16 lanes are summed once,
            // after the last tile (alpha is the same in all of them)
            l_run[i] = l_run[i] * alpha + part;
#pragma unroll
            for (int j = 0; j < NV; ++j)
#pragma unroll
                for (int c = 0; c < VW; ++c) acc[i][j][c] *= alpha;
        }

        // V(tile) and P are visible; everyone is done reading K(tile).
        cp_async_wait_all();
        __syncthreads();
        if (tile + 1 < n_tiles)
            load_tile<T, D, kBlockK, QS>(
                k_s, k_g + static_cast<long long>(tile + 1) * kBlockK * p.k_st,
                p.k_st, tid);

        // ---- O += P V, columns (16 j + tx) * VW + c
#pragma unroll 2
        for (int kk = 0; kk < kBlockK; kk += 4) {
            float vf[4][NV][VW];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const float* src = v_s + (kk + r) * D + (16 * j + tx) * VW;
                    if constexpr (VW == 4) {
                        const float4 x = *reinterpret_cast<const float4*>(src);
                        vf[r][j][0] = x.x; vf[r][j][1] = x.y;
                        vf[r][j][2] = x.z; vf[r][j][3] = x.w;
                    } else {
                        const float2 x = *reinterpret_cast<const float2*>(src);
                        vf[r][j][0] = x.x; vf[r][j][1] = x.y;
                    }
                }
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const float4 pf = *reinterpret_cast<const float4*>(
                    p_s + (ty + 16 * i) * kPStride + kk);
                const float pr[4] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int j = 0; j < NV; ++j)
#pragma unroll
                        for (int c = 0; c < VW; ++c)
                            acc[i][j][c] = fmaf(pr[r], vf[r][j][c],
                                                acc[i][j][c]);
            }
        }
    }

    // ---- o = acc / l, lse = m + log l (back in natural-log units)
    T* o_g = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh
        + static_cast<long long>(q0) * p.o_st;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        float l = l_run[i];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            l += __shfl_xor_sync(0xffffffffu, l, off);
        const float inv = 1.0f / l;
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            T* dst = o_g + row * p.o_st + (16 * j + tx) * VW;
            if constexpr (VW == 4) {
                Elem<T>::store4(dst, make_float4(
                    acc[i][j][0] * inv, acc[i][j][1] * inv,
                    acc[i][j][2] * inv, acc[i][j][3] * inv));
            } else {
                Elem<T>::store2(dst, acc[i][j][0] * inv, acc[i][j][1] * inv);
            }
        }
        if (p.lse != nullptr && tx == 0)
            p.lse[static_cast<long long>(bh) * p.t + q0 + row] =
                (m_run[i] + log2f(l)) * 0.69314718055994530942f;
    }
}

template <typename T, int D, int BQ>
cudaError_t launch(const FlashParams& p, int batch, cudaStream_t stream) {
    constexpr int kBytes = Layout<D, BQ>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.t / BQ, batch * p.heads);
    flash_fwd_kernel<T, D, BQ><<<grid, kThreads, kBytes, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_d(const FlashParams& p, int batch, int d,
                         cudaStream_t stream) {
    switch (d) {
        case 32: return launch<T, 32, 128>(p, batch, stream);
        case 64: return launch<T, 64, 128>(p, batch, stream);
        case 128: return launch<T, 128, 128>(p, batch, stream);
        case 256: return launch<T, 256, 64>(p, batch, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. t must be a multiple of 128, the query tile
// (64 at d = 256 divides it). Strides in elements; the last dimension of
// q, k, v and o is contiguous. lse may be null. Launches on `stream`, does
// not synchronise, allocates nothing; returns the CUDA error code.
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
    p.q_scale = 1.44269504088896340736f / sqrtf(static_cast<float>(d));
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

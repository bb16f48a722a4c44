// The split pass of the float32 flash-attention kernels on wgmma, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: it is the port's own, and exists because of how
// the float32 forward and dkv reach Hopper's warpgroup tensor-core products
// (flash_attention.cu::flash_fwd_wgmma_kernel<float, ...>,
// flash_attention_bwd.cu::flash_bwd_dkv_wgmma_kernel<float, ...>). They
// run 3xTF32 (hi*hi + hi*lo + lo*hi, float32 accuracy, never TF32 alone),
// and wgmma takes TF32 operands only K-major (the reduced dimension along
// the row) and B only from shared memory. So each float32 operand is split
// here once per call, into contiguous planes that the kernels load by TMA
// as they are:
//
//   hi = x rounded to TF32 (cvt.rn.tf32.f32, to nearest even), lo = x - hi
//   (exact; the tensor core reads its top 19 bits), in the operand's
//   (B, H, T, D) order ("K-major": Q and K of S = Q K^T; also V and dO in
//   dkv's S^T = K Q^T and dP^T = V dO^T), and
//   hi and lo of the operand transposed to (B, H, D, T) ("transposed": V of
//   O += P V; Q and dO of dK += dS^T Q and dV += P^T dO), each group of 8
//   rows of T written in the order 0, 2, 4, 6, 1, 3, 5, 7: P (or P^T, dS^T)
//   enters its product from the accumulator, whose fragment holds columns
//   2t and 2t + 1 where a TF32 A fragment's k slots t and t + 4 sit
//   (flash_wgmma.cuh, tf32_frag).
//
// Rounding hi to nearest and not leaving it to the tensor core's truncation
// is what keeps the kernels within twice the plain float32 version's error
// (tests/test_torch_port_flash_split.py). What bounds the pass on an H100:
// bytes (it does two flops an element); each operand is read once and 2 or
// 4 planes of its size are written, coalesced, 16 bytes a thread in the
// operand's order and 4 bytes a thread, through shared memory, transposed.
// One launch splits every operand of a call (grid z); a block takes 32 rows
// of one operand of one batch*head. Plain C interface; the entry returns the
// CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOps = 4;
constexpr int kRows = 32;      // rows of T per block
constexpr int kThreads = 256;

struct SplitOp {
    const float* x;
    long long sb, sh, st;  // element strides; the last dimension contiguous
    int modes;             // 1 K-major planes, 2 transposed planes
    int first_plane;       // its first plane's index
};

struct SplitParams {
    SplitOp op[kMaxOps];
    float* planes;         // (planes, B, H, T, D) float32, contiguous
    long long plane_elems; // B * H * T * D
    int heads;
    int t;
};

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
    uint32_t h;
    asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
    hi = __uint_as_float(h);
    lo = x - hi;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const SplitParams p) {
    __shared__ float tile[kRows][D + 1];
    const SplitOp& op = p.op[blockIdx.z];
    const int bh = blockIdx.y;
    const int b = bh / p.heads;
    const int h = bh % p.heads;
    const int t0 = blockIdx.x * kRows;
    const float* src = op.x + b * op.sb + h * op.sh
        + static_cast<long long>(t0) * op.st;
    float* plane = p.planes + op.first_plane * p.plane_elems;
    const bool kmajor = op.modes & 1;
    const bool transposed = op.modes & 2;

    float* hi_k = plane + (static_cast<long long>(bh) * p.t + t0) * D;
    float* lo_k = hi_k + p.plane_elems;
    constexpr int kVecs = D / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
        const int r = i / kVecs;
        const int c = (i % kVecs) * 4;
        const float4 x = *reinterpret_cast<const float4*>(src + r * op.st + c);
        if (kmajor) {
            float4 hi, lo;
            split(x.x, hi.x, lo.x);
            split(x.y, hi.y, lo.y);
            split(x.z, hi.z, lo.z);
            split(x.w, hi.w, lo.w);
            *reinterpret_cast<float4*>(hi_k + r * D + c) = hi;
            *reinterpret_cast<float4*>(lo_k + r * D + c) = lo;
        }
        if (transposed) {
            tile[r][c] = x.x;
            tile[r][c + 1] = x.y;
            tile[r][c + 2] = x.z;
            tile[r][c + 3] = x.w;
        }
    }
    if (!transposed) return;  // uniform over the block
    __syncthreads();
    float* hi_t = plane + (kmajor ? 2 : 0) * p.plane_elems
        + static_cast<long long>(bh) * D * p.t + t0;
    float* lo_t = hi_t + p.plane_elems;
    for (int i = threadIdx.x; i < D * kRows; i += kThreads) {
        const int d = i / kRows;
        const int pos = i % kRows;
        // position q of a group of 8 holds row 2q (q < 4) or 2q - 7
        const int q = pos & 7;
        const int row = (pos & ~7) + (q < 4 ? 2 * q : 2 * q - 7);
        float hi, lo;
        split(tile[row][d], hi, lo);
        hi_t[static_cast<long long>(d) * p.t + pos] = hi;
        lo_t[static_cast<long long>(d) * p.t + pos] = lo;
    }
}

}  // namespace

// n_ops operands (at most 4) of one (batch, heads, t, d) shape, float32,
// each `xs[i]` with element strides strides[3 i .. 3 i + 2] (batch, head,
// row; the last dimension contiguous, strides multiples of 4, 16-byte
// aligned) and modes[i] (1: its K-major hi and lo planes, 2: its transposed
// ones, 3: both, K-major first). Writes the planes in that order into
// `planes`, (planes, batch, heads, t, d) contiguous. d must be 64 or 128
// and t a multiple of 32. Launches one kernel on `stream`, does not
// synchronise, allocates nothing; returns the CUDA error code.
extern "C" int pai_flash_split(int n_ops, const void* const* xs,
                               const long long* strides, const int* modes,
                               float* planes, int batch, int heads, int t,
                               int d, void* stream) {
    if (n_ops <= 0 || n_ops > kMaxOps || batch <= 0 || heads <= 0 ||
        t <= 0 || t % kRows != 0 ||
        static_cast<long long>(batch) * heads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    SplitParams p;
    p.planes = planes;
    p.plane_elems = static_cast<long long>(batch) * heads * t * d;
    p.heads = heads;
    p.t = t;
    int next = 0;
    for (int i = 0; i < n_ops; ++i) {
        if (modes[i] < 1 || modes[i] > 3)
            return static_cast<int>(cudaErrorInvalidValue);
        p.op[i].x = static_cast<const float*>(xs[i]);
        p.op[i].sb = strides[3 * i];
        p.op[i].sh = strides[3 * i + 1];
        p.op[i].st = strides[3 * i + 2];
        p.op[i].modes = modes[i];
        p.op[i].first_plane = next;
        next += (modes[i] & 1 ? 2 : 0) + (modes[i] & 2 ? 2 : 0);
    }
    const dim3 grid(t / kRows, batch * heads, n_ops);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 64)
        flash_split_kernel<64><<<grid, kThreads, 0, s>>>(p);
    else if (d == 128)
        flash_split_kernel<128><<<grid, kThreads, 0, s>>>(p);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

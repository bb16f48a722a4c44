// Fused windowed-SSIM kernels for NVIDIA Hopper (sm_90a), plain C interface.
//
// These replace the two Pallas TPU kernels of pai_tpu/kernels/ssim_pallas.py:
//   * ssim_map_kernel    <- _ssim_map_kernel    (full-resolution SSIM map,
//                           torch 'reflect' padding folded into the blur)
//   * ssim_scalar_kernel <- _ssim_scalar_kernel (per-image interior-mean SSIM
//                           from VALID windows only, no map written)
// They compute what those kernels compute (torchmetrics SSIM: 11-tap separable
// Gaussian window, (2 mu_pt + c1)(2 sigma_pt + c2) / ((mu_p^2 + mu_t^2 + c1)
// (sigma_p + sigma_t + c2))), not how: the TPU kernels blur with dense banded
// matrix products and hold a whole image pair in fast memory, which suits a
// matrix unit and megabytes of VMEM. Here the work is a separable stencil.
//
// Design. One block of 32x8 threads owns a 32x16 tile of output pixels of one
// (image, channel) plane; grid = (tiles_w, tiles_h, planes). The block
//   1. loads the (16+10)x(32+10) halo of pred and target into shared memory
//      once -- through a reflected source index for the map kernel, a plain
//      in-bounds index for the scalar kernel (its windows never leave the
//      image) -- reading the tensors through their element strides, so the
//      row-band views that depth_ssim makes need no copy;
//   2. blurs p, t, p*p, t*t, p*t horizontally (11 taps) into shared memory;
//   3. blurs vertically in registers and evaluates the SSIM ratio.
// All arithmetic is float32 FMAs on the CUDA cores: the SSIM ratio amplifies
// rounding (sigma = E[x^2] - mu^2 cancels), so no tensor cores and no TF32.
// The taps live in __constant__ memory and are computed on the host.
//
// The scalar kernel reduces its tile inside the block (warp shuffles, then
// shared memory), writes one partial per block to scratch[plane][tile], and a
// second small kernel sums each image's partials in a fixed order: the result
// is deterministic and needs no float atomics.
//
// Bound on an H100: both kernels are bound by bytes (two float32 reads, and
// for the map one float32 write, per pixel against ~240 flop per pixel), and
// at the report's shapes that bound is a few microseconds, below the cost of
// a launch. The design therefore reads each input from device memory once per
// tile (the halo re-reads hit L2) and keeps every intermediate on chip.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int KS = 11;            // window taps
constexpr int HALO = KS - 1;      // 10
constexpr int PAD = HALO / 2;     // 5
constexpr int TW = 32;            // tile width  (output pixels)
constexpr int TH = 16;            // tile height (output pixels)
constexpr int BX = 32;            // threads along x
constexpr int BY = 8;             // threads along y
constexpr int NT = BX * BY;       // 256 threads
constexpr int IN_W = TW + HALO;   // 42
constexpr int IN_H = TH + HALO;   // 26
constexpr int IN_WP = IN_W + 1;   // padded row length in shared memory
constexpr int ROWS = TH / BY;     // output rows per thread
constexpr int FINISH_NT = 256;

__constant__ float c_taps[KS];

struct View {               // a (N, H, W, C) tensor seen through its strides
  const float* data;
  long long sn, sh, sw, sc;  // element strides
};

template <bool REFLECT>
__device__ __forceinline__ int source_index(int s, int n) {
  if (REFLECT) {            // torch 'reflect': the edge sample is not repeated
    if (s < 0) s = -s;
    else if (s >= n) s = 2 * (n - 1) - s;
  }
  // Only positions that feed masked-out outputs of a ragged tile are clamped.
  return min(max(s, 0), n - 1);
}

__device__ __forceinline__ float ssim_ratio(float mu_p, float mu_t, float e_pp,
                                            float e_tt, float e_pt, float c1,
                                            float c2) {
  const float mu_p_sq = mu_p * mu_p;
  const float mu_t_sq = mu_t * mu_t;
  const float mu_pt = mu_p * mu_t;
  const float sigma_p = e_pp - mu_p_sq;
  const float sigma_t = e_tt - mu_t_sq;
  const float sigma_pt = e_pt - mu_pt;
  return ((2.0f * mu_pt + c1) * (2.0f * sigma_pt + c2)) /
         ((mu_p_sq + mu_t_sq + c1) * (sigma_p + sigma_t + c2));
}

// SSIM of this thread's ROWS output pixels of the tile at (x0, y0) of plane
// (n, c): pixel r is (y0 + threadIdx.y + r * BY, x0 + threadIdx.x). Output
// coordinates are map coordinates when REFLECT (window centred on the pixel,
// reflected at the borders) and interior coordinates otherwise (the window
// starts at the pixel: VALID windows over the unpadded image).
template <bool REFLECT>
__device__ __forceinline__ void tile_ssim(const View& pred, const View& target,
                                          int n, int c, int H, int W, int x0,
                                          int y0, float c1, float c2,
                                          float (&out)[ROWS]) {
  __shared__ float s_p[IN_H][IN_WP];
  __shared__ float s_t[IN_H][IN_WP];
  __shared__ float s_h[5][IN_H][TW];

  const int tid = threadIdx.y * BX + threadIdx.x;
  constexpr int OFF = REFLECT ? PAD : 0;

  const float* p_plane = pred.data + n * pred.sn + c * pred.sc;
  const float* t_plane = target.data + n * target.sn + c * target.sc;
  for (int i = tid; i < IN_H * IN_W; i += NT) {
    const int r = i / IN_W;
    const int q = i - r * IN_W;
    const int sy = source_index<REFLECT>(y0 + r - OFF, H);
    const int sx = source_index<REFLECT>(x0 + q - OFF, W);
    s_p[r][q] = p_plane[sy * pred.sh + sx * pred.sw];
    s_t[r][q] = t_plane[sy * target.sh + sx * target.sw];
  }
  __syncthreads();

  for (int i = tid; i < IN_H * TW; i += NT) {
    const int r = i / TW;
    const int q = i - r * TW;
    float hp = 0.0f, ht = 0.0f, hpp = 0.0f, htt = 0.0f, hpt = 0.0f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float g = c_taps[k];
      const float p = s_p[r][q + k];
      const float t = s_t[r][q + k];
      hp = fmaf(g, p, hp);
      ht = fmaf(g, t, ht);
      hpp = fmaf(g, p * p, hpp);
      htt = fmaf(g, t * t, htt);
      hpt = fmaf(g, p * t, hpt);
    }
    s_h[0][r][q] = hp;
    s_h[1][r][q] = ht;
    s_h[2][r][q] = hpp;
    s_h[3][r][q] = htt;
    s_h[4][r][q] = hpt;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = threadIdx.y + j * BY;
    float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float g = c_taps[k];
#pragma unroll
      for (int m = 0; m < 5; ++m)
        v[m] = fmaf(g, s_h[m][r + k][threadIdx.x], v[m]);
    }
    out[j] = ssim_ratio(v[0], v[1], v[2], v[3], v[4], c1, c2);
  }
  __syncthreads();  // the caller may loop to another plane and reload
}

// Full-resolution SSIM map, contiguous (N, H, W, C) float32.
__global__ void __launch_bounds__(NT)
ssim_map_kernel(View pred, View target, float* __restrict__ map, int planes,
                int H, int W, int C, float c1, float c2) {
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  for (int z = blockIdx.z; z < planes; z += gridDim.z) {
    const int n = z / C;
    const int c = z - n * C;
    float vals[ROWS];
    tile_ssim<true>(pred, target, n, c, H, W, x0, y0, c1, c2, vals);
    const int x = x0 + threadIdx.x;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int y = y0 + threadIdx.y + j * BY;
      if (x < W && y < H)
        map[(((long long)n * H + y) * W + x) * C + c] = vals[j];
    }
  }
}

// Sum of the interior SSIM values of one tile -> partials[plane][tile].
__global__ void __launch_bounds__(NT)
ssim_scalar_kernel(View pred, View target, float* __restrict__ partials,
                   int planes, int H, int W, int C, float c1, float c2) {
  __shared__ float s_warp[NT / 32];
  const int OH = H - HALO;
  const int OW = W - HALO;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.y * BX + threadIdx.x;
  for (int z = blockIdx.z; z < planes; z += gridDim.z) {
    const int n = z / C;
    const int c = z - n * C;
    float vals[ROWS];
    tile_ssim<false>(pred, target, n, c, H, W, x0, y0, c1, c2, vals);
    const int x = x0 + threadIdx.x;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int y = y0 + threadIdx.y + j * BY;
      if (x < OW && y < OH) acc += vals[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) total += s_warp[w];
      partials[(long long)z * tiles + tile] = total;
    }
    __syncthreads();
  }
}

// out[n] = sum(partials[n][:per_image]) * inv_count, in a fixed order.
__global__ void __launch_bounds__(FINISH_NT)
ssim_finish_kernel(const float* __restrict__ partials, float* __restrict__ out,
                   int per_image, float inv_count) {
  __shared__ float s_sum[FINISH_NT];
  const float* src = partials + (long long)blockIdx.x * per_image;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < per_image; i += FINISH_NT) acc += src[i];
  s_sum[threadIdx.x] = acc;
  __syncthreads();
  for (int o = FINISH_NT / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s_sum[threadIdx.x] += s_sum[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s_sum[0] * inv_count;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
constexpr int MAX_GRID_Z = 65535;

}  // namespace

extern "C" {

// Tile geometry, so the wrapper can size the scalar kernel's scratch.
int pai_ssim_tile_w() { return TW; }
int pai_ssim_tile_h() { return TH; }

// Copy the KS Gaussian taps (host pointer) into __constant__ memory of the
// current device. Synchronous; called once per device before any launch.
int pai_ssim_set_taps(const float* taps) {
  return (int)cudaMemcpyToSymbol(c_taps, taps, KS * sizeof(float));
}

int pai_ssim_map(const float* pred, long long psn, long long psh,
                 long long psw, long long psc, const float* target,
                 long long tsn, long long tsh, long long tsw, long long tsc,
                 float* map, int N, int H, int W, int C, float c1, float c2,
                 void* stream) {
  const View p{pred, psn, psh, psw, psc};
  const View t{target, tsn, tsh, tsw, tsc};
  const int planes = N * C;
  const dim3 grid(ceil_div(W, TW), ceil_div(H, TH),
                  planes < MAX_GRID_Z ? planes : MAX_GRID_Z);
  ssim_map_kernel<<<grid, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      p, t, map, planes, H, W, C, c1, c2);
  return (int)cudaGetLastError();
}

// partials: scratch of N*C*tiles floats, tiles = ceil((W-10)/TW) *
// ceil((H-10)/TH); out: N floats.
int pai_ssim_scalar(const float* pred, long long psn, long long psh,
                    long long psw, long long psc, const float* target,
                    long long tsn, long long tsh, long long tsw,
                    long long tsc, float* partials, float* out, int N, int H,
                    int W, int C, float c1, float c2, void* stream) {
  const View p{pred, psn, psh, psw, psc};
  const View t{target, tsn, tsh, tsw, tsc};
  const int planes = N * C;
  const int OH = H - HALO, OW = W - HALO;
  const dim3 grid(ceil_div(OW, TW), ceil_div(OH, TH),
                  planes < MAX_GRID_Z ? planes : MAX_GRID_Z);
  ssim_scalar_kernel<<<grid, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      p, t, partials, planes, H, W, C, c1, c2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_image = C * (int)(grid.x * grid.y);
  const float inv_count = 1.0f / ((float)C * (float)OH * (float)OW);
  ssim_finish_kernel<<<N, FINISH_NT, 0, (cudaStream_t)stream>>>(
      partials, out, per_image, inv_count);
  return (int)cudaGetLastError();
}

}  // extern "C"

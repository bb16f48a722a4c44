// Fused windowed-SSIM kernels for NVIDIA Hopper (sm_90a), plain C interface.
//
// They replace the two Pallas TPU kernels of pai_tpu/kernels/ssim_pallas.py:
//   * _ssim_map_kernel    (full-resolution SSIM map, torch 'reflect' padding
//                          folded into the blur)      -> ssim_rows_kernel<true>
//   * _ssim_scalar_kernel (per-image interior-mean SSIM from VALID windows
//                          only, no map written)      -> ssim_rows_kernel<false>
// each followed by ssim_finish_kernel, which turns row sums into means. They
// compute what those kernels compute (torchmetrics SSIM: 11-tap separable
// Gaussian window, (2 mu_pt + c1)(2 sigma_pt + c2) / ((mu_p^2 + mu_t^2 + c1)
// (sigma_p + sigma_t + c2))), not how: the TPU kernels blur with dense banded
// matrix products and hold a whole image pair in fast memory. Here the work
// is a separable stencil on the CUDA cores.
//
// Bound on an H100: bytes. Two float32 reads per pixel (and one write for the
// map) against ~240 float32 operations; at (8,256,256,1) the byte bound is
// 1.9 us and the arithmetic about the same. What held the earlier tiled kernel
// back (32x16 tiles of 256 threads) was everything around that: each input byte
// read 2.1 times through scalar loads behind an integer division and a
// reflect test, 1.6 horizontal blurs per output row, three barriers per
// tile, and 17 launches per report batch.
//
// Design. One block is one warp and owns a strip of 32 columns (one column
// per lane) and ROWS output rows of one (image, channel) plane; it walks DOWN
// the strip. The ROWS + 10 input rows of the strip are copied once into
// shared memory by cp.async, in two halves (the second is in flight while
// the first is blurred): 16-byte copies where the row is contiguous and
// aligned and the strip lies inside the image, 4-byte copies through the
// element strides otherwise, their reflected column offsets computed once
// per block. Each input row is blurred horizontally once (11 taps, five
// moments p, t, p*p, t*t, p*t) into a ring of 11 rows x 5 moments held in
// registers: the row loop is unrolled by 11, so every ring slot has a
// compile-time index. Each output row is the vertical 11-tap sum of the
// ring, oldest row first, and the SSIM ratio. The warp keeps its values in
// shared memory and, at the end, lane r adds row r's interior columns
// [5, W-5) left to right and writes one float per (plane, strip, row). No
// __syncthreads: a block is one warp.
//
// Measured on the card (PERF.md): the kernel issues some 2.5 warp
// instructions per SM cycle of a possible 4; 55 + 55 FMAs and 33 products per
// pixel row are the floor of this arithmetic. ROWS = 16 (1,024 warps at the
// report's shape, 1.6 horizontal blurs per output row) was the fastest of 8
// to 64.
//
// The map kernel covers every pixel, reflecting rows and columns near the
// borders (torch 'reflect': the edge sample is not repeated); the VALID
// variant covers only the interior [5, H-5) x [5, W-5), whose windows never
// leave the image, so it needs no reflection and the same taps give the same
// values there. Every per-image mean the port needs -- the whole image's, or a
// depth band's -- is a mean over a range of interior rows of those row sums:
// a depth band [s, e) of more than 10 rows has its interior rows [s+5, e-5)
// and columns [5, W-5) wholly inside the image interior, where the band's own
// windows read exactly the whole image's values. ssim_finish_kernel adds, per
// (image, row range), the row sums of that range in a fixed order: the result
// is bit-reproducible and needs no float atomics. It is a second launch, not
// a last-block-done tail inside the row kernel: one block per (image, row
// range) spreads the report's 17 sums of an image over 17 blocks. A tail
// (per image, the warp that finished the image's last strip, after a
// __threadfence in every block) was measured on the card (PERF.md): 4.5 us
// slower for the scalar's one row range and 19 us slower for a report
// batch's 17, more than the second launch costs.
//
// All arithmetic is float32 FMAs in the tap order of the plain version
// (horizontal, then vertical, tap 0 first): the SSIM ratio amplifies rounding
// (sigma = E[x^2] - mu^2 cancels), so no tensor cores and no TF32. The taps
// live in __constant__ memory and are computed on the host.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int KS = 11;               // window taps
constexpr int HALO = KS - 1;         // 10
constexpr int PAD = HALO / 2;        // 5
constexpr int STRIP = 32;            // columns per block: one per lane
constexpr int ROWS = 16;             // output rows per block
constexpr int SEG = STRIP + HALO;    // 42 input columns a strip row reads
constexpr int LEAD = 8;              // shared column 0 is strip column -8
constexpr int BUF_W = 48;            // 12 16-byte chunks: columns -8 .. 39
static_assert(ROWS <= STRIP, "one lane adds each output row's sum");
constexpr int IN_ROWS = ROWS + HALO; // input rows a block blurs
constexpr int FIRST_HALF = IN_ROWS / 2;
constexpr int MAX_SEGMENTS = 64;
constexpr int FINISH_NT = 128;
constexpr int MAX_GRID_Z = 65535;

__constant__ float c_taps[KS];

struct View {               // a (N, H, W, C) tensor seen through its strides
  const float* data;
  long long sn, sh, sw, sc;  // element strides
};

struct Segments {           // row ranges [lo, hi) of the map, one mean each
  int lo[MAX_SEGMENTS];
  int hi[MAX_SEGMENTS];
};

// torch 'reflect' (H, W > 10, so one reflection reaches any index a window
// asks for), then clamped: only columns that feed masked-out lanes of a
// ragged strip can still lie outside.
__device__ __forceinline__ int reflect(int s, int n) {
  if (s < 0) s = -s;
  else if (s >= n) s = 2 * (n - 1) - s;
  return min(max(s, 0), n - 1);
}

__device__ __forceinline__ float ssim_ratio(const float (&v)[5], float c1,
                                            float c2) {
  const float mu_p_sq = v[0] * v[0];
  const float mu_t_sq = v[1] * v[1];
  const float mu_pt = v[0] * v[1];
  const float sigma_p = v[2] - mu_p_sq;
  const float sigma_t = v[3] - mu_t_sq;
  const float sigma_pt = v[4] - mu_pt;
  return ((2.0f * mu_pt + c1) * (2.0f * sigma_pt + c2)) /
         ((mu_p_sq + mu_t_sq + c1) * (sigma_p + sigma_t + c2));
}

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// What one block keeps in shared memory: the input rows of its strip, in two
// halves (the second half is still in flight while the first is blurred),
// and its SSIM values, for the row sums.
struct Tile {
  float p[IN_ROWS][BUF_W];  // input columns x0-8 .. x0+39
  float t[IN_ROWS][BUF_W];
  float val[ROWS][STRIP + 1];
};

// Where a block's lanes copy from within a row: per lane the element offsets
// of two columns of p and two of t (columns x0-5+lane and x0+27+lane, the
// second for lanes 0-9 only), reflected at the image's edges; fixed for the
// whole block, so a row costs each lane a base address and four copies.
struct Columns {
  long long p0, p1, t0, t1;
};

__device__ __forceinline__ Columns strip_columns(const View& pred,
                                                 const View& target, int x0,
                                                 int W) {
  const int lane = threadIdx.x;
  const int s0 = reflect(x0 - PAD + lane, W);
  const int s1 = reflect(x0 - PAD + STRIP + lane, W);
  return {s0 * pred.sw, s1 * pred.sw, s0 * target.sw, s1 * target.sw};
}

// Issue the copies of source row `sy` of plane (n, c) into tile row `r`.
__device__ __forceinline__ void load_row(Tile& tile, int r, const View& pred,
                                         const View& target, int n, int c,
                                         int sy, int x0, bool vec_strip,
                                         const Columns& cols) {
  const int lane = threadIdx.x;
  const float* p_row = pred.data + n * pred.sn + c * pred.sc + sy * pred.sh;
  const float* t_row =
      target.data + n * target.sn + c * target.sc + sy * target.sh;
  if (vec_strip) {  // 12 chunks of p on lanes 0-11, of t on lanes 12-23
    if (lane < 12)
      copy_async(&tile.p[r][4 * lane], p_row + (x0 - LEAD + 4 * lane), 16);
    else if (lane < 24)
      copy_async(&tile.t[r][4 * (lane - 12)],
                 t_row + (x0 - LEAD + 4 * (lane - 12)), 16);
  } else {          // 42 columns of each, one element at a time
    copy_async(&tile.p[r][LEAD - PAD + lane], p_row + cols.p0, 4);
    copy_async(&tile.t[r][LEAD - PAD + lane], t_row + cols.t0, 4);
    if (lane < SEG - STRIP) {
      copy_async(&tile.p[r][LEAD - PAD + STRIP + lane], p_row + cols.p1, 4);
      copy_async(&tile.t[r][LEAD - PAD + STRIP + lane], t_row + cols.t1, 4);
    }
  }
}

// Input row i: its horizontal 11-tap blur at this lane's column into ring
// slot `slot`; then, once 11 rows are in, output row y0 + i - 10 from the
// ring read oldest first from slot `oldest` (taps in the plain version's
// order), its SSIM value into the map and the tile's value rows.
template <bool WRITE_MAP>
__device__ __forceinline__ void blur_row(float (&h)[KS][5], int slot,
                                         int oldest, Tile& tile, float* map,
                                         int i, int n, int c, int H, int W,
                                         int C, int x, int y0,
                                         bool interior_col, float c1,
                                         float c2) {
  const int lane = threadIdx.x;
  const float* sp = &tile.p[i][LEAD - PAD + lane];
  const float* st = &tile.t[i][LEAD - PAD + lane];
  float hp = 0.0f, ht = 0.0f, hpp = 0.0f, htt = 0.0f, hpt = 0.0f;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float g = c_taps[k];
    const float p = sp[k];
    const float t = st[k];
    hp = fmaf(g, p, hp);
    ht = fmaf(g, t, ht);
    hpp = fmaf(g, p * p, hpp);
    htt = fmaf(g, t * t, htt);
    hpt = fmaf(g, p * t, hpt);
  }
  h[slot][0] = hp;
  h[slot][1] = ht;
  h[slot][2] = hpp;
  h[slot][3] = htt;
  h[slot][4] = hpt;
  if (i < HALO) return;
  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float g = c_taps[k];
#pragma unroll
    for (int m = 0; m < 5; ++m)
      v[m] = fmaf(g, h[(oldest + k) % KS][m], v[m]);
  }
  const float val = ssim_ratio(v, c1, c2);
  if (WRITE_MAP && x < W)
    map[(((long long)n * H + y0 + i - HALO) * W + x) * C + c] = val;
  tile.val[i - HALO][lane] = interior_col ? val : 0.0f;
}

// SSIM over the output rows [y0, y1) of one strip of one plane; rows are map
// rows (window centred on the row), the source row reflected. rowsums: this
// (plane, strip)'s row sums, indexed by y - y_lo.
template <bool WRITE_MAP>
__device__ __forceinline__ void strip_rows(
    Tile& tile, const View& pred, const View& target, float* map,
    float* rowsums, int n, int c, int H, int W, int C, int x0, int y0, int y1,
    int y_lo, bool vec_strip, float c1, float c2) {
  const int lane = threadIdx.x;
  const int x = x0 + lane;
  const int n_in = y1 - y0 + HALO;
  const bool interior_col = x >= PAD && x < W - PAD;

  const Columns cols = strip_columns(pred, target, x0, W);
  for (int r = 0; r < min(n_in, FIRST_HALF); ++r)
    load_row(tile, r, pred, target, n, c, reflect(y0 - PAD + r, H), x0,
             vec_strip, cols);
  commit_group();
  for (int r = FIRST_HALF; r < n_in; ++r)
    load_row(tile, r, pred, target, n, c, reflect(y0 - PAD + r, H), x0,
             vec_strip, cols);
  commit_group();
  wait_groups<1>();  // the first half has landed
  __syncwarp();

  // The 11 most recent rows of horizontal moments: input row i in slot
  // i % 11, a compile-time index since the row loop is unrolled by 11.
  float h[KS][5];
  for (int base = 0; base < n_in; base += KS) {
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int i = base + j;
      if (i >= n_in) break;
      if (i == FIRST_HALF) {
        wait_groups<0>();
        __syncwarp();
      }
      blur_row<WRITE_MAP>(h, j, (j + 1) % KS, tile, map, i, n, c, H, W, C,
                          x0 + lane, y0, interior_col, c1, c2);
    }
  }
  __syncwarp();
  // row sums over the strip's interior columns, left to right
  if (lane < y1 - y0) {
    float sum = 0.0f;
#pragma unroll 8
    for (int q = 0; q < STRIP; ++q) sum += tile.val[lane][q];
    rowsums[y0 - y_lo + lane] = sum;
  }
  __syncwarp();  // the tile is refilled for the next plane
}

// Row sums (and, WRITE_MAP, the map) of the region [y_lo, y_hi) x [x_lo,
// x_hi): the whole map, or the interior. Grid: (strips, row chunks, planes);
// strips start at multiples of 32 columns, lanes outside [x_lo, x_hi) are
// masked. rowsums: [plane][strip][y - y_lo].
template <bool WRITE_MAP>
__global__ void __launch_bounds__(STRIP)
ssim_rows_kernel(View pred, View target, float* __restrict__ map,
                 float* __restrict__ rowsums, int planes, int H, int W, int C,
                 int y_lo, int y_hi, int x_lo, bool vec, float c1, float c2) {
  __shared__ __align__(16) Tile tile;
  const int strip = blockIdx.x;
  const int x0 = (x_lo / STRIP + strip) * STRIP;
  const int y0 = y_lo + blockIdx.y * ROWS;
  const int y1 = min(y0 + ROWS, y_hi);
  const int row_count = y_hi - y_lo;
  // 16-byte copies: a contiguous, aligned row and a strip whose 48 columns
  // lie inside the image (no reflection)
  const bool vec_strip = vec && x0 - LEAD >= 0 && x0 - LEAD + BUF_W <= W;
  for (int z = blockIdx.z; z < planes; z += gridDim.z) {
    const int n = z / C;
    const int c = z - n * C;
    strip_rows<WRITE_MAP>(
        tile, pred, target, map,
        rowsums + ((long long)z * gridDim.x + strip) * row_count, n, c, H, W,
        C, x0, y0, y1, y_lo, vec_strip, c1, c2);
  }
}

// out[s * N + n] = mean over planes of image n, strips and rows [lo_s, hi_s)
// of the row sums, divided by C * rows * (W - 10). Thread i adds row i of
// every (plane, strip) in turn, then row i + 128, ..., then the threads' sums
// are added as a tree: a fixed order of adds.
__global__ void __launch_bounds__(FINISH_NT)
ssim_finish_kernel(const float* __restrict__ rowsums, float* __restrict__ out,
                   Segments seg, int N, int C, int strips, int y_lo,
                   int row_count, int W) {
  __shared__ float s_sum[FINISH_NT];
  const int n = blockIdx.x;
  const int s = blockIdx.y;
  const int lo = seg.lo[s] - y_lo;
  const int rows = seg.hi[s] - seg.lo[s];
  const float* src = rowsums + (long long)n * C * strips * row_count + lo;
  float acc = 0.0f;
  for (int r = threadIdx.x; r < rows; r += FINISH_NT)
#pragma unroll 8
    for (int q = 0; q < C * strips; ++q) acc += src[(long long)q * row_count + r];
  s_sum[threadIdx.x] = acc;
  __syncthreads();
  for (int o = FINISH_NT / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s_sum[threadIdx.x] += s_sum[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    out[(long long)s * N + n] =
        s_sum[0] / ((float)C * (float)rows * (float)(W - HALO));
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Strip width in columns, so the wrapper can size the row sums:
// planes x strips x rows floats, strips = ceil(x_hi / 32) - x_lo / 32.
int pai_ssim_strip() { return STRIP; }
int pai_ssim_max_segments() { return MAX_SEGMENTS; }

// Copy the KS Gaussian taps (host pointer) into __constant__ memory of the
// current device. Synchronous; called once per device before any launch.
int pai_ssim_set_taps(const float* taps) {
  return (int)cudaMemcpyToSymbol(c_taps, taps, KS * sizeof(float));
}

// write_map != 0: the whole map [0, H) x [0, W) is written to `map` (a
// contiguous (N, H, W, C) float32 buffer) and row sums kept for every map
// row; write_map == 0: only the interior [5, H-5) x [5, W-5) is computed and
// nothing but its row sums is written. Then out[s * N + n] = the mean SSIM
// of image n over map rows [seg_lo[s], seg_hi[s]) (interior rows only) and
// the interior columns. vec != 0: rows are contiguous (W stride 1) and every
// row start is 16-byte aligned. rowsums: scratch of planes x strips x rows.
int pai_ssim_rows(const float* pred, long long psn, long long psh,
                  long long psw, long long psc, const float* target,
                  long long tsn, long long tsh, long long tsw, long long tsc,
                  float* map, float* rowsums, float* out, int N, int H, int W,
                  int C, int write_map, int vec, const int* seg_lo,
                  const int* seg_hi, int n_seg, float c1, float c2,
                  void* stream) {
  if (n_seg < 1 || n_seg > MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  const View p{pred, psn, psh, psw, psc};
  const View t{target, tsn, tsh, tsw, tsc};
  const int planes = N * C;
  const int y_lo = write_map ? 0 : PAD, y_hi = write_map ? H : H - PAD;
  const int x_lo = write_map ? 0 : PAD, x_hi = write_map ? W : W - PAD;
  const int strips = ceil_div(x_hi, STRIP) - x_lo / STRIP;
  Segments seg;
  for (int s = 0; s < n_seg; ++s) {
    if (seg_lo[s] < PAD || seg_hi[s] > H - PAD || seg_hi[s] <= seg_lo[s])
      return (int)cudaErrorInvalidValue;
    seg.lo[s] = seg_lo[s];
    seg.hi[s] = seg_hi[s];
  }
  const dim3 grid(strips, ceil_div(y_hi - y_lo, ROWS),
                  planes < MAX_GRID_Z ? planes : MAX_GRID_Z);
  if (write_map)
    ssim_rows_kernel<true><<<grid, STRIP, 0, (cudaStream_t)stream>>>(
        p, t, map, rowsums, planes, H, W, C, y_lo, y_hi, x_lo, vec != 0, c1,
        c2);
  else
    ssim_rows_kernel<false><<<grid, STRIP, 0, (cudaStream_t)stream>>>(
        p, t, map, rowsums, planes, H, W, C, y_lo, y_hi, x_lo, vec != 0, c1,
        c2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssim_finish_kernel<<<dim3(N, n_seg), FINISH_NT, 0, (cudaStream_t)stream>>>(
      rowsums, out, seg, N, C, strips, y_lo, y_hi - y_lo, W);
  return (int)cudaGetLastError();
}

}  // extern "C"

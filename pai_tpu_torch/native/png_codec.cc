// Native PNG codec + antialiased resize + threaded batch decode, the host
// side of pai_tpu_torch's image path (the reference delegates it to
// torchvision's C++: dataset.py:51-61 read_image / Resize, report.py
// write_png). A copy of the JAX package's pai_tpu/native/png_codec.cc with the
// same functions and C interface; decode failures here carry a reason code.
// Exposed as a C ABI consumed via ctypes (png_native.py); ctypes calls
// release the interpreter lock, so the batch decoder's threads overlap PNG
// decode with the device's work.
//
// Supported PNG subset: 8-bit and 16-bit (the high byte is kept), color types
// gray(0), RGB(2), palette(3, 8-bit only), gray+alpha(4), RGBA(6),
// non-interlaced. Anything else is refused with kUnsupported; there is no
// other decoder behind this one.
//
// Built at first use by pai_tpu_torch/native/__init__.py
// (c++ -O3 -fPIC -std=c++17 -Wall png_codec.cc -shared -lz -lpthread).

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

// Why a decode failed; 0 is success. pai_read_png_gray returns the negated
// code, pai_decode_batch_u8 stores it per file in `failed`.
enum Status : int {
  kOk = 0,
  kUnreadable = 1,   // the file cannot be opened or read
  kNotPng = 2,       // no PNG signature
  kUnsupported = 3,  // outside the subset above
  kCorrupt = 4,      // truncated chunks, bad zlib data, bad filter/palette
  kNoMemory = 5,
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = v >> 16;
  p[2] = v >> 8;
  p[3] = v;
}

struct PngImage {
  int width = 0;
  int height = 0;
  int channels = 0;  // after expansion: 1, 2, 3 or 4
  int bit_depth = 8;
  std::vector<uint8_t> pixels;  // 8-bit, interleaved
};

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = in.size();
  std::vector<uint8_t> buf(1 << 18);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = buf.size();
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

// Decode a PNG file into 8-bit interleaved pixels.
Status decode_png(const char* path, PngImage* img) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kUnreadable;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return kUnreadable;
  }
  std::vector<uint8_t> data(size);
  if (std::fread(data.data(), 1, size, f) != size_t(size)) {
    std::fclose(f);
    return kUnreadable;
  }
  std::fclose(f);
  if (size < 8 || std::memcmp(data.data(), kPngSig, 8) != 0) return kNotPng;

  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  size_t off = 8;
  while (off + 8 <= data.size()) {
    uint32_t len = be32(&data[off]);
    if (off + 12 + len > data.size()) return kCorrupt;
    const uint8_t* type = &data[off + 4];
    const uint8_t* body = &data[off + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!std::memcmp(type, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (width <= 0 || height <= 0) return kCorrupt;
  if (interlace != 0) return kUnsupported;
  if (bit_depth != 8 && bit_depth != 16) return kUnsupported;

  int raw_channels;
  switch (color_type) {
    case 0: raw_channels = 1; break;
    case 2: raw_channels = 3; break;
    case 3: raw_channels = 1; break;  // palette indices
    case 4: raw_channels = 2; break;
    case 6: raw_channels = 4; break;
    default: return kUnsupported;
  }
  if (color_type == 3 && bit_depth != 8) return kUnsupported;

  std::vector<uint8_t> raw;
  if (!inflate_all(idat, raw)) return kCorrupt;

  const int bytes_per_sample = bit_depth / 8;
  const int bpp = raw_channels * bytes_per_sample;  // filter unit
  const size_t stride = size_t(width) * bpp;
  if (raw.size() < (stride + 1) * height) return kCorrupt;

  // Unfilter in place into `recon`.
  std::vector<uint8_t> recon(stride * height);
  const uint8_t* src = raw.data();
  for (int y = 0; y < height; ++y) {
    uint8_t filter = src[y * (stride + 1)];
    const uint8_t* line = src + y * (stride + 1) + 1;
    uint8_t* out = recon.data() + y * stride;
    const uint8_t* prev = y ? recon.data() + (y - 1) * stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? out[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return kCorrupt;
      }
      out[x] = uint8_t(v);
    }
  }

  // Expand to 8-bit interleaved channels.
  img->width = width;
  img->height = height;
  if (color_type == 3) {
    if (palette.empty()) return kCorrupt;
    img->channels = 3;
    img->pixels.resize(size_t(width) * height * 3);
    for (size_t i = 0; i < size_t(width) * height; ++i) {
      int idx = recon[i] * 3;
      if (size_t(idx + 2) >= palette.size()) return kCorrupt;
      img->pixels[i * 3 + 0] = palette[idx];
      img->pixels[i * 3 + 1] = palette[idx + 1];
      img->pixels[i * 3 + 2] = palette[idx + 2];
    }
  } else if (bit_depth == 16) {
    img->channels = raw_channels;
    img->pixels.resize(size_t(width) * height * raw_channels);
    for (size_t i = 0; i < img->pixels.size(); ++i)
      img->pixels[i] = recon[i * 2];  // high byte
  } else {
    img->channels = raw_channels;
    img->pixels.assign(recon.begin(), recon.end());
  }
  return kOk;
}

// ITU-R 601-2 luma (torchvision ImageReadMode.GRAY semantics).
void to_gray(const PngImage& img, std::vector<uint8_t>& gray) {
  const size_t n = size_t(img.width) * img.height;
  gray.resize(n);
  if (img.channels == 1) {
    std::memcpy(gray.data(), img.pixels.data(), n);
  } else if (img.channels == 2) {  // gray + alpha
    for (size_t i = 0; i < n; ++i) gray[i] = img.pixels[i * 2];
  } else {
    const int c = img.channels;
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = &img.pixels[i * c];
      float v = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      gray[i] = uint8_t(v + 0.5f);
    }
  }
}

// Triangle-filter (antialiased bilinear) resample of one channel, the
// torchvision Resize(antialias=True) semantics.
void resize_aa_f32(const uint8_t* src, int sh, int sw, float* dst, int dh,
                   int dw) {
  if (sh == dh && sw == dw) {
    for (int i = 0; i < sh * sw; ++i) dst[i] = src[i] / 255.0f;
    return;
  }
  std::vector<float> tmp(size_t(sh) * dw);

  auto make_weights = [](int in_size, int out_size,
                         std::vector<int>& starts, std::vector<float>& weights,
                         int& ksize) {
    const float scale = float(in_size) / out_size;
    const float support = scale >= 1.0f ? scale : 1.0f;
    ksize = int(std::ceil(support)) * 2 + 1;
    starts.assign(out_size, 0);
    weights.assign(size_t(out_size) * ksize, 0.0f);
    for (int i = 0; i < out_size; ++i) {
      const float center = (i + 0.5f) * scale;
      int lo = std::max(0, int(std::floor(center - support + 0.5f)));
      int hi = std::min(in_size, int(std::floor(center + support + 0.5f)));
      starts[i] = lo;
      float total = 0.0f;
      for (int j = lo; j < hi; ++j) {
        float x = std::abs((j + 0.5f - center) / (scale >= 1.f ? scale : 1.f));
        float w = x < 1.0f ? 1.0f - x : 0.0f;
        weights[size_t(i) * ksize + (j - lo)] = w;
        total += w;
      }
      if (total > 0)
        for (int j = 0; j < hi - lo; ++j)
          weights[size_t(i) * ksize + j] /= total;
    }
  };

  std::vector<int> xs, ys;
  std::vector<float> xw, yw;
  int xk, yk;
  make_weights(sw, dw, xs, xw, xk);
  make_weights(sh, dh, ys, yw, yk);

  for (int y = 0; y < sh; ++y)
    for (int x = 0; x < dw; ++x) {
      float acc = 0.0f;
      const float* w = &xw[size_t(x) * xk];
      int lo = xs[x];
      for (int j = 0; j < xk && lo + j < sw; ++j)
        acc += w[j] * src[size_t(y) * sw + lo + j];
      tmp[size_t(y) * dw + x] = acc;
    }
  for (int y = 0; y < dh; ++y) {
    const float* w = &yw[size_t(y) * yk];
    int lo = ys[y];
    for (int x = 0; x < dw; ++x) {
      float acc = 0.0f;
      for (int j = 0; j < yk && lo + j < sh; ++j)
        acc += w[j] * tmp[size_t(lo + j) * dw + x];
      dst[size_t(y) * dw + x] = acc / 255.0f;
    }
  }
}

uint32_t crc_of(const uint8_t* type, const uint8_t* data, size_t len) {
  uint32_t c = crc32(0L, Z_NULL, 0);
  c = crc32(c, type, 4);
  if (len) c = crc32(c, data, len);
  return c;
}

void write_chunk(FILE* f, const char* type, const uint8_t* data, size_t len) {
  uint8_t hdr[8];
  put_be32(hdr, uint32_t(len));
  std::memcpy(hdr + 4, type, 4);
  std::fwrite(hdr, 1, 8, f);
  if (len) std::fwrite(data, 1, len, f);
  uint8_t crc[4];
  put_be32(crc, crc_of(reinterpret_cast<const uint8_t*>(type), data, len));
  std::fwrite(crc, 1, 4, f);
}

}  // namespace

extern "C" {

// Decode a PNG as grayscale uint8 into a malloc'd buffer (freed with
// pai_free). Returns 0, or the negated Status of the failure.
int pai_read_png_gray(const char* path, uint8_t** out, int* h, int* w) {
  PngImage img;
  const Status status = decode_png(path, &img);
  if (status != kOk) return -status;
  std::vector<uint8_t> gray;
  to_gray(img, gray);
  *out = static_cast<uint8_t*>(std::malloc(gray.size()));
  if (!*out) return -kNoMemory;
  std::memcpy(*out, gray.data(), gray.size());
  *h = img.height;
  *w = img.width;
  return 0;
}

void pai_free(void* p) { std::free(p); }

// Write a PNG (grayscale if channels==1, RGB if 3). compress 0..9; the
// reference writes at compression_level=0 (palette.py:166).
int pai_write_png(const char* path, const uint8_t* data, int h, int w,
                  int channels, int compress) {
  if (channels != 1 && channels != 3) return -1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  std::fwrite(kPngSig, 1, 8, f);

  uint8_t ihdr[13];
  put_be32(ihdr, uint32_t(w));
  put_be32(ihdr + 4, uint32_t(h));
  ihdr[8] = 8;                              // bit depth
  ihdr[9] = channels == 1 ? 0 : 2;          // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  write_chunk(f, "IHDR", ihdr, 13);

  const size_t stride = size_t(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;  // filter: none
    std::memcpy(&raw[y * (stride + 1) + 1], data + y * stride, stride);
  }
  uLongf bound = compressBound(raw.size());
  std::vector<uint8_t> z(bound);
  if (compress2(z.data(), &bound, raw.data(), raw.size(),
                compress) != Z_OK) {
    std::fclose(f);
    return -3;
  }
  write_chunk(f, "IDAT", z.data(), bound);
  write_chunk(f, "IEND", nullptr, 0);
  std::fclose(f);
  return 0;
}

// Antialiased resize of a uint8 grayscale image into float32 [0,1].
int pai_resize_aa(const uint8_t* src, int sh, int sw, float* dst, int dh,
                  int dw) {
  resize_aa_f32(src, sh, sw, dst, dh, dw);
  return 0;
}

// Threaded batch pipeline (uint8 output): decode n PNGs, resize to
// (size,size) and round back to uint8 — exactly torchvision's
// read_image(GRAY) + Resize(antialias) on uint8 tensors (dataset.py:51-61),
// which rounds the resized result to uint8 before the float conversion.
// Host->device transfer then ships 1 byte/px instead of 4. failed[i] is 0 or
// the Status of file i; returns the number of failures.
int pai_decode_batch_u8(const char** paths, int n, int size, uint8_t* out,
                        uint8_t* failed, int num_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<float> tmp(size_t(size) * size);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      PngImage img;
      const Status status = decode_png(paths[i], &img);
      failed[i] = uint8_t(status);
      if (status != kOk) {
        failures.fetch_add(1);
        continue;
      }
      std::vector<uint8_t> gray;
      to_gray(img, gray);
      uint8_t* dst = out + size_t(i) * size * size;
      if (img.height == size && img.width == size) {
        std::memcpy(dst, gray.data(), size_t(size) * size);
      } else {
        resize_aa_f32(gray.data(), img.height, img.width, tmp.data(), size,
                      size);
        for (int j = 0; j < size * size; ++j) {
          float v = tmp[j] * 255.0f + 0.5f;
          dst[j] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
      }
    }
  };
  int nt = num_threads > 0 ? num_threads : 4;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"

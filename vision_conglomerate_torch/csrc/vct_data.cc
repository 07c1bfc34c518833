// vct_data: host-side image decode + resize for the input pipeline of the
// PyTorch port (a copy of the JAX package's native/vct_data.cc, kept here
// so the port builds its own library).
//
// Multi-threaded libjpeg/libpng decode (format sniffed from the magic
// bytes) fused with a resize straight into a caller-provided uint8 NHWC
// batch buffer: half-pixel bilinear (cv2.INTER_LINEAR) or PIL's
// antialiased bicubic. The trainers divide by 255 on the device.
//
// Bound with ctypes by vision_conglomerate_torch/data/native_loader.py,
// which builds it with g++ -O3 -shared against the system libjpeg and
// libpng.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG bytes to an RGB buffer. Returns 0 on success.
int decode_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>& out,
               int& width, int& height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  width = cinfo.output_width;
  height = cinfo.output_height;
  out.resize(static_cast<size_t>(width) * height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Bilinear resize (half-pixel centers, matching cv2.INTER_LINEAR /
// torch align_corners=False) from src RGB to dst RGB.
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* d = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        d[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

// ---- PNG ------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep dst, png_size_t n) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "read past end of PNG buffer");
    return;
  }
  std::memcpy(dst, st->data + st->pos, n);
  st->pos += n;
}

// Decode PNG bytes to an RGB8 buffer (alpha dropped, palette/gray expanded,
// 16-bit stripped — matching PIL Image.convert("RGB")). Returns 0 on success.
int decode_png_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>& out,
                   int& width, int& height) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);

  width = png_get_image_width(png, info);
  height = png_get_image_height(png, info);
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // drop alpha (PIL .convert("RGB") discards it; tRNS becomes alpha first)
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out.resize(static_cast<size_t>(width) * height * 3);
  std::vector<png_bytep> rows(height);
  for (int y = 0; y < height; ++y)
    rows[y] = out.data() + static_cast<size_t>(y) * width * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// Format sniffing: PNG signature vs JPEG SOI marker.
bool is_png(const uint8_t* data, size_t len) {
  return len >= 8 && !png_sig_cmp(data, 0, 8);
}
bool is_jpeg(const uint8_t* data, size_t len) {
  return len >= 2 && data[0] == 0xFF && data[1] == 0xD8;
}

int decode_any_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>& out,
                   int& width, int& height) {
  if (is_png(data, len)) return decode_png_rgb(data, len, out, width, height);
  if (is_jpeg(data, len)) return decode_rgb(data, len, out, width, height);
  return 1;
}

// ---- PIL-style antialiased bicubic resize ----------------------------
//
// PIL Image.resize defaults to Resampling.BICUBIC with antialias: a
// separable convolution whose support scales with the downsampling factor
// (Keys cubic, a = -0.5). The reference's dataset pipeline resizes with
// exactly this (utils/utils.py:32-40), so the native loader must match it
// (float intermediates here vs PIL's int16 fixed point: <=1 LSB apart).

float bicubic_filter(float x) {
  constexpr float a = -0.5f;
  x = std::abs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Precompute, for each output index, the source window and normalized
// weights (PIL ImagingResampleHorizontal/precompute_coeffs).
void precompute_coeffs(int src, int dst, std::vector<int>& bounds,
                       std::vector<float>& weights, int& ksize) {
  constexpr float kSupport = 2.0f;  // bicubic
  const float scale = static_cast<float>(src) / dst;
  const float filterscale = std::max(scale, 1.0f);
  const float support = kSupport * filterscale;
  ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.resize(static_cast<size_t>(dst) * 2);
  weights.assign(static_cast<size_t>(dst) * ksize, 0.0f);
  for (int i = 0; i < dst; ++i) {
    const float center = (i + 0.5f) * scale;
    int xmin = static_cast<int>(center - support + 0.5f);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5f);
    if (xmax > src) xmax = src;
    const int n = xmax - xmin;
    float* w = &weights[static_cast<size_t>(i) * ksize];
    float total = 0.0f;
    for (int k = 0; k < n; ++k) {
      w[k] = bicubic_filter((xmin + k + 0.5f - center) / filterscale);
      total += w[k];
    }
    if (total != 0.0f)
      for (int k = 0; k < n; ++k) w[k] /= total;
    bounds[i * 2] = xmin;
    bounds[i * 2 + 1] = n;
  }
}

// Separable resample: horizontal into a float buffer, then vertical.
void resize_pil_bicubic(const uint8_t* src, int sw, int sh, uint8_t* dst,
                        int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  std::vector<int> xb, yb;
  std::vector<float> xw, yw;
  int xk, yk;
  precompute_coeffs(sw, dw, xb, xw, xk);
  precompute_coeffs(sh, dh, yb, yw, yk);

  // PIL quantizes to uint8 AFTER EACH PASS (clip8 in
  // ImagingResampleHorizontal_8bpc), so the intermediate must be uint8 too.
  auto clip8 = [](float v) -> uint8_t {
    const float r = v + 0.5f;
    return static_cast<uint8_t>(r < 0.0f ? 0 : (r > 255.0f ? 255 : r));
  };
  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int xmin = xb[x * 2], n = xb[x * 2 + 1];
      const float* w = &xw[static_cast<size_t>(x) * xk];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = srow + (xmin + k) * 3;
        acc[0] += p[0] * w[k];
        acc[1] += p[1] * w[k];
        acc[2] += p[2] * w[k];
      }
      for (int c = 0; c < 3; ++c) trow[x * 3 + c] = clip8(acc[c]);
    }
  }
  for (int y = 0; y < dh; ++y) {
    const int ymin = yb[y * 2], n = yb[y * 2 + 1];
    const float* w = &yw[static_cast<size_t>(y) * yk];
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = tmp.data() + (static_cast<size_t>(ymin + k) * dw + x) * 3;
        acc[0] += p[0] * w[k];
        acc[1] += p[1] * w[k];
        acc[2] += p[2] * w[k];
      }
      for (int c = 0; c < 3; ++c) drow[x * 3 + c] = clip8(acc[c]);
    }
  }
}

}  // namespace

extern "C" {

// Decode one image (JPEG or PNG, sniffed) and resize into out
// (out_h * out_w * 3 uint8, RGB). resize_mode: 0 = bilinear half-pixel
// (cv2.INTER_LINEAR), 1 = PIL-style antialiased bicubic (the reference
// dataset path). Returns 0 on success.
int vct_decode_resize_mode(const uint8_t* jpeg_data, size_t jpeg_len,
                           int out_w, int out_h, uint8_t* out,
                           int resize_mode) {
  std::vector<uint8_t> rgb;
  int w, h;
  if (decode_any_rgb(jpeg_data, jpeg_len, rgb, w, h)) return 1;
  if (resize_mode == 1)
    resize_pil_bicubic(rgb.data(), w, h, out, out_w, out_h);
  else
    resize_bilinear(rgb.data(), w, h, out, out_w, out_h);
  return 0;
}

int vct_decode_resize(const uint8_t* jpeg_data, size_t jpeg_len,
                      int out_w, int out_h, uint8_t* out) {
  return vct_decode_resize_mode(jpeg_data, jpeg_len, out_w, out_h, out, 0);
}

// Batch decode+resize with an internal thread pool. jpegs: array of n
// pointers; lens: array of n lengths; out: n * out_h * out_w * 3 uint8.
// Returns number of failed decodes (0 == all ok; failed slots are zeroed).
int vct_decode_resize_batch_mode(const uint8_t** jpegs, const size_t* lens,
                                 int n, int out_w, int out_h, uint8_t* out,
                                 int n_threads, int resize_mode) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min(n_threads, n));
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  const size_t stride = static_cast<size_t>(out_w) * out_h * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      if (vct_decode_resize_mode(jpegs[i], lens[i], out_w, out_h,
                                 out + stride * i, resize_mode)) {
        std::memset(out + stride * i, 0, stride);
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

int vct_decode_resize_batch(const uint8_t** jpegs, const size_t* lens, int n,
                            int out_w, int out_h, uint8_t* out, int n_threads) {
  return vct_decode_resize_batch_mode(jpegs, lens, n, out_w, out_h, out,
                                      n_threads, 0);
}

// Probe image dimensions without a full decode (JPEG or PNG, sniffed).
int vct_probe(const uint8_t* jpeg_data, size_t jpeg_len, int* w, int* h) {
  if (is_png(jpeg_data, jpeg_len)) {
    // PNG IHDR is always the first chunk: width/height big-endian at 16/20.
    if (jpeg_len < 24) return 1;
    if (memcmp(jpeg_data + 12, "IHDR", 4) != 0) return 1;  // corrupt header
    const uint8_t* p = jpeg_data + 16;
    *w = (p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
    *h = (p[4] << 24) | (p[5] << 16) | (p[6] << 8) | p[7];
    return 0;
  }
  if (!is_jpeg(jpeg_data, jpeg_len)) return 1;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(jpeg_data), jpeg_len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"

// Native image ingest: JPEG/PNG decode + PIL-convention bilinear resize to a
// square uint8 RGB canvas, in one C++ call.
//
// The reference decodes with PIL and resizes with HF feature extractors per
// sample per epoch inside DataLoader workers (reference datasets.py:154-181);
// this framework decodes once into a uint8 cache (data/images.py). This
// module is the native fast path for that cache build / on-miss decode:
//
//  * JPEG rides libjpeg's DCT scaling — the decoder emits 1/2, 1/4 or 1/8
//    scale straight from the entropy-decoded coefficients, so a 3000px photo
//    headed for a 224px canvas never materializes at full resolution
//    (3-8x faster than full decode + resize);
//  * the resample is PIL's triangle (BILINEAR) convention — support widened
//    by the scale factor on downscale (antialiased), float accumulation —
//    so outputs track the PIL path within ~1 LSB at full scale;
//  * PNG (the reference's jpg->png fallback, datasets.py:164-167) decodes
//    via libpng with palette/gray/alpha normalized to RGB8.
//
// Exact-parity note: the default ingest stays PIL (data/images.py); this
// path is opt-in (--img_decoder native) because DCT-scaled decode is not
// bit-identical to full decode + PIL resize. tests/test_torch_imgdec.py
// bounds the deviation (exact on PNG; <=2 LSB full-scale JPEG; PSNR-checked
// scaled).
//
// Build (data/native.py does it at first use, into build/imgdec/, with
// -march=native and the host CPU's tag in the file name):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 imgdec.cpp -o libsmtc_imgdec.so \
//       -ljpeg -lpng

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// PIL-convention separable triangle resample (Resampling.BILINEAR).
// For each output pixel, a window of input pixels weighted by a triangle
// kernel whose support scales with the downscale ratio (antialias), float
// accumulation, round-half-away like PIL's fixed-point rounding target.
// ---------------------------------------------------------------------------

struct ResamplePlan {
  std::vector<int> lo;           // first source index per output pixel
  std::vector<int> n;            // window length per output pixel
  std::vector<std::vector<float>> w;  // normalized weights
};

ResamplePlan plan_triangle(int in_size, int out_size) {
  ResamplePlan p;
  p.lo.resize(out_size);
  p.n.resize(out_size);
  p.w.resize(out_size);
  const double scale = double(in_size) / double(out_size);
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // triangle radius
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = (int)std::max(0.0, std::floor(center - support + 0.5));
    int xmax = (int)std::min((double)in_size,
                             std::floor(center + support + 0.5));
    int n = xmax - xmin;
    if (n <= 0) { n = 1; xmin = std::min(std::max(xmin, 0), in_size - 1); }
    std::vector<float> w((size_t)n);
    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      double x = (xmin + i + 0.5 - center) / filterscale;
      double v = (x < 0) ? -x : x;
      double tw = (v < 1.0) ? (1.0 - v) : 0.0;
      w[(size_t)i] = (float)tw;
      total += tw;
    }
    if (total > 0) {
      for (int i = 0; i < n; ++i) w[(size_t)i] = (float)(w[(size_t)i] / total);
    } else {
      w.assign((size_t)n, 1.0f / n);
    }
    p.lo[xx] = xmin;
    p.n[xx] = n;
    p.w[xx] = std::move(w);
  }
  return p;
}

// rgb (h, w, 3) uint8 -> (out_size, out_size, 3) uint8
// (PIL img.resize((out_size, out_size)) semantics, data/images.py resize_to_u8)
void resize_triangle_rgb(const unsigned char* src, int w, int h, int out_size,
                         unsigned char* dst) {
  const int out_w = out_size, out_h = out_size;
  ResamplePlan px = plan_triangle(w, out_w);
  ResamplePlan py = plan_triangle(h, out_h);
  // horizontal pass: (h, w, 3) -> (h, out_w, 3) float
  std::vector<float> tmp((size_t)h * out_w * 3);
  for (int y = 0; y < h; ++y) {
    const unsigned char* row = src + (size_t)y * w * 3;
    float* trow = tmp.data() + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      float r = 0, g = 0, b = 0;
      const int lo = px.lo[x], n = px.n[x];
      const float* wt = px.w[x].data();
      for (int i = 0; i < n; ++i) {
        const unsigned char* s = row + (size_t)(lo + i) * 3;
        r += wt[i] * s[0]; g += wt[i] * s[1]; b += wt[i] * s[2];
      }
      trow[(size_t)x * 3 + 0] = r;
      trow[(size_t)x * 3 + 1] = g;
      trow[(size_t)x * 3 + 2] = b;
    }
  }
  // vertical pass: (h, out_w, 3) -> (out_h, out_w, 3) uint8
  for (int y = 0; y < out_h; ++y) {
    const int lo = py.lo[y], n = py.n[y];
    const float* wt = py.w[y].data();
    unsigned char* drow = dst + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      for (int i = 0; i < n; ++i)
        acc += wt[i] * tmp[(size_t)(lo + i) * out_w * 3 + x];
      int v = (int)std::lround((double)acc);
      drow[x] = (unsigned char)std::min(255, std::max(0, v));
    }
  }
}

// ---------------------------------------------------------------------------
// JPEG via libjpeg (DCT-scaled when a target size is given)
// ---------------------------------------------------------------------------

struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jerr_exit(j_common_ptr cinfo) {
  JerrMgr* err = reinterpret_cast<JerrMgr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Decode an in-memory JPEG to RGB8. If target > 0, pick the largest DCT
// downscale (1/2, 1/4, 1/8) that keeps BOTH dims >= target. Returns
// malloc'd buffer (caller frees) or nullptr.
unsigned char* decode_jpeg_mem(const unsigned char* data, unsigned long len,
                               int target, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  unsigned char* buf = nullptr;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(buf);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;  // PIL's accuracy baseline
  if (target > 0) {
    unsigned denom = 1;
    while (denom < 8) {
      unsigned next = denom * 2;
      if ((cinfo.image_width / next) >= (unsigned)target &&
          (cinfo.image_height / next) >= (unsigned)target)
        denom = next;
      else
        break;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  const int w = (int)cinfo.output_width;
  const int h = (int)cinfo.output_height;
  const int ch = (int)cinfo.output_components;  // 3 with JCS_RGB
  if (ch != 3) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  buf = (unsigned char*)std::malloc((size_t)w * h * 3);
  if (!buf) {  // decompression bombs / memory pressure -> clean PIL fallback
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = buf + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_w = w;
  *out_h = h;
  return buf;
}

// Read a whole file (serving gets bytes directly; cache builds go via path).
bool read_file(const char* path, std::vector<unsigned char>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  if (n < 0) { std::fclose(f); return false; }
  std::fseek(f, 0, SEEK_SET);
  out->resize((size_t)n);
  const bool ok = n == 0 || std::fread(out->data(), 1, (size_t)n, f) == (size_t)n;
  std::fclose(f);
  return ok;
}

unsigned char* decode_jpeg(const char* path, int target, int* out_w,
                           int* out_h) {
  std::vector<unsigned char> bytes;
  if (!read_file(path, &bytes) || bytes.empty()) return nullptr;
  return decode_jpeg_mem(bytes.data(), (unsigned long)bytes.size(), target,
                         out_w, out_h);
}

// ---------------------------------------------------------------------------
// PNG via libpng (palette/gray/alpha -> RGB8; alpha dropped like PIL's
// convert("RGB"))
// ---------------------------------------------------------------------------

struct PngMemCursor {
  const unsigned char* data;
  size_t len, pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngMemCursor* c = (PngMemCursor*)png_get_io_ptr(png);
  if (c->pos + n > c->len) png_error(png, "read past end");
  std::memcpy(out, c->data + c->pos, n);
  c->pos += n;
}

unsigned char* decode_png_mem(const unsigned char* data, size_t len,
                              int* out_w, int* out_h) {
  if (len < 8 || png_sig_cmp(const_cast<unsigned char*>(data), 0, 8))
    return nullptr;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  unsigned char* buf = nullptr;
  std::vector<png_bytep> rows;
  PngMemCursor cur{data, len, 8};
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::free(buf);
    return nullptr;
  }
  png_set_read_fn(png, &cur, png_mem_read);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  const int w = (int)png_get_image_width(png, info);
  const int h = (int)png_get_image_height(png, info);
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // drop alpha (PIL convert("RGB") composes over black only for some modes;
  // for RGBA it drops the channel — match that)
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  buf = (unsigned char*)std::malloc((size_t)w * h * 3);
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  rows.resize((size_t)h);
  for (int y = 0; y < h; ++y) rows[(size_t)y] = buf + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *out_w = w;
  *out_h = h;
  return buf;
}

unsigned char* decode_png(const char* path, int* out_w, int* out_h) {
  std::vector<unsigned char> bytes;
  if (!read_file(path, &bytes)) return nullptr;
  return decode_png_mem(bytes.data(), bytes.size(), out_w, out_h);
}

bool is_png_mem(const unsigned char* data, size_t len) {
  return len >= 8 && !png_sig_cmp(const_cast<unsigned char*>(data), 0, 8);
}

bool is_png(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char sig[8];
  const bool ok = std::fread(sig, 1, 8, f) == 8 && !png_sig_cmp(sig, 0, 8);
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Decode (JPEG or PNG, sniffed by signature) + resize to a
// (out_size, out_size, 3) uint8 RGB canvas. Returns 0 on success,
// negative on failure (caller falls back to the PIL path).
int smtc_decode_resize(const char* path, int out_size, unsigned char* out) {
  int w = 0, h = 0;
  unsigned char* buf = is_png(path) ? decode_png(path, &w, &h)
                                    : decode_jpeg(path, out_size, &w, &h);
  if (!buf) return -1;
  resize_triangle_rgb(buf, w, h, out_size, out);
  std::free(buf);
  return 0;
}

// In-memory variant (serving: requests arrive as base64 bytes, no file).
int smtc_decode_resize_mem(const unsigned char* data, long len, int out_size,
                           unsigned char* out) {
  if (len <= 0) return -1;
  int w = 0, h = 0;
  unsigned char* buf =
      is_png_mem(data, (size_t)len)
          ? decode_png_mem(data, (size_t)len, &w, &h)
          : decode_jpeg_mem(data, (unsigned long)len, out_size, &w, &h);
  if (!buf) return -1;
  resize_triangle_rgb(buf, w, h, out_size, out);
  std::free(buf);
  return 0;
}

// Full-scale decode into caller memory of capacity cap bytes; writes RGB8
// and the dimensions. Returns 0, -1 (decode failure) or -2 (capacity).
// Used by the parity tests (decode-only vs PIL).
int smtc_decode_full(const char* path, unsigned char* out, long cap,
                     int* out_w, int* out_h) {
  int w = 0, h = 0;
  unsigned char* buf = is_png(path) ? decode_png(path, &w, &h)
                                    : decode_jpeg(path, 0, &w, &h);
  if (!buf) return -1;
  if ((long)w * h * 3 > cap) {
    std::free(buf);
    return -2;
  }
  std::memcpy(out, buf, (size_t)w * h * 3);
  std::free(buf);
  *out_w = w;
  *out_h = h;
  return 0;
}

}  // extern "C"

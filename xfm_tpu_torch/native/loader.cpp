// The pretrain task's host image path: threaded JPEG/PNG decode (JPEG at
// 1/2, 1/4 or 1/8 scale in the DCT domain where the crop allows it), crop,
// bilinear resize and horizontal flip into a uint8 [B, S, S, 3] batch, and
// RandAugment's ops with PIL's conventions, in place on such a batch.
//
// A copy of xfm_tpu/native/loader.cpp (the same function). Plain C ABI,
// loaded with ctypes; workers are std::threads and ctypes releases the GIL
// for the whole call. xfm_tpu_torch/native/__init__.py builds it with
//   g++ -O3 -march=native -shared -fPIC loader.cpp -o <lib>.so
//       -ljpeg -lpng -lpthread

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

struct Image {
  std::vector<uint8_t> rgb;  // HWC, 3 channels
  int w = 0, h = 0;          // decoded dims (may be scaled, JPEG only)
  int full_w = 0, full_h = 0;  // pre-scaling dims from the header
};

// ---------------------------------------------------------------- JPEG ----
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// scale_denom in {1,2,4,8}: libjpeg decodes directly at 1/k scale in the
// DCT domain — ~k^2 less IDCT/color work, the cheapest possible downscale
// when the requested crop is much larger than the output size.
bool decode_jpeg(const uint8_t* data, long len, Image* out,
                 int scale_denom = 1) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->full_w = cinfo.image_width;
  out->full_h = cinfo.image_height;
  cinfo.out_color_space = JCS_RGB;
  if (scale_denom > 1) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = scale_denom;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG ----
struct PngReadState {
  const uint8_t* data;
  long len;
  long pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + static_cast<long>(n) > s->len) {
    png_error(png, "eof");
    return;
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* data, long len, Image* out) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->full_w = out->w;
  out->full_h = out->h;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_any(const uint8_t* data, long len, Image* out,
                int scale_denom = 1) {
  if (len > 3 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, out, scale_denom);
  if (len > 8 && data[0] == 0x89 && data[1] == 'P')
    return decode_png(data, len, out);
  // try both as fallback
  return decode_jpeg(data, len, out, scale_denom) ||
         decode_png(data, len, out);
}

int dims_fast_impl(const uint8_t* data, long len, int* w, int* h);

// Largest denom in {8,4,2} whose scaled crop still covers out_size in both
// dims (the final bilinear resize stays a downscale — no resolution loss in
// the output); 1 when the header can't be parsed or the crop is small.
int pick_scale_denom(const uint8_t* data, long len, const int* crop,
                     int out_size) {
  if (!(len > 3 && data[0] == 0xFF && data[1] == 0xD8)) return 1;  // JPEG only
  int w = 0, h = 0;
  if (dims_fast_impl(data, len, &w, &h) != 0) return 1;
  int cw = crop[2] > 0 ? crop[2] : w;
  int ch = crop[3] > 0 ? crop[3] : h;
  if (cw > w) cw = w;
  if (ch > h) ch = h;
  int m = cw < ch ? cw : ch;
  for (int k = 8; k > 1; k /= 2)
    if (m >= out_size * k) return k;
  return 1;
}

// Rescale full-frame crop coords into the (possibly scaled) decode space.
void scale_crop(const Image& img, const int* crop, int* out) {
  double rx = double(img.w) / (img.full_w > 0 ? img.full_w : img.w);
  double ry = double(img.h) / (img.full_h > 0 ? img.full_h : img.h);
  out[0] = int(crop[0] * rx + 0.5);
  out[1] = int(crop[1] * ry + 0.5);
  out[2] = crop[2] > 0 ? int(crop[2] * rx + 0.5) : crop[2];
  out[3] = crop[3] > 0 ? int(crop[3] * ry + 0.5) : crop[3];
}

// bilinear crop+resize from src (region x,y,w,h) to out_size×out_size RGB,
// optional horizontal flip.
void crop_resize(const Image& src, int cx, int cy, int cw, int ch,
                 int out_size, int hflip, uint8_t* out) {
  if (cw <= 0 || ch <= 0) {
    cx = 0; cy = 0; cw = src.w; ch = src.h;
  }
  if (cx < 0) cx = 0;
  if (cy < 0) cy = 0;
  if (cx + cw > src.w) cw = src.w - cx;
  if (cy + ch > src.h) ch = src.h - cy;
  const float sx = float(cw) / out_size;
  const float sy = float(ch) / out_size;
  for (int oy = 0; oy < out_size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f + cy;
    if (fy < 0) fy = 0;
    int y0 = int(fy);
    int y1 = y0 + 1 < src.h ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int ox = 0; ox < out_size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f + cx;
      if (fx < 0) fx = 0;
      int x0 = int(fx);
      int x1 = x0 + 1 < src.w ? x0 + 1 : x0;
      float wx = fx - x0;
      int tx = hflip ? (out_size - 1 - ox) : ox;
      uint8_t* dst = out + (size_t(oy) * out_size + tx) * 3;
      for (int c = 0; c < 3; ++c) {
        float v00 = src.rgb[(size_t(y0) * src.w + x0) * 3 + c];
        float v01 = src.rgb[(size_t(y0) * src.w + x1) * 3 + c];
        float v10 = src.rgb[(size_t(y1) * src.w + x0) * 3 + c];
        float v11 = src.rgb[(size_t(y1) * src.w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// ----------------------------------------------------------- RandAugment --
// PIL-convention augment ops on [S,S,3] uint8 images; the magnitude maps
// follow data/randaugment.py. The tests hold each op to PIL itself and to
// the JAX package's copy of this file.

enum RandaugOp {
  OP_IDENTITY = 0,
  OP_AUTOCONTRAST = 1,
  OP_EQUALIZE = 2,
  OP_BRIGHTNESS = 3,
  OP_SHARPNESS = 4,
  OP_SHEARX = 5,
  OP_SHEARY = 6,
  OP_TRANSLATEX = 7,
  OP_TRANSLATEY = 8,
  OP_ROTATE = 9,
  OP_INVERT = 10,
  OP_POSTERIZE = 11,
  OP_SOLARIZE = 12,
  OP_COLOR = 13,
  OP_CONTRAST = 14,
};

constexpr float kMaxLevel = 10.0f;
constexpr uint8_t kFill = 128;  // REPLACE gray

inline uint8_t clip_trunc(float v) {
  // PIL ImagingBlend semantics: clip then TRUNCATE to uint8.
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return static_cast<uint8_t>(v);
}

void op_lut(uint8_t* img, int S, const uint8_t* lut /* [3][256] */) {
  for (int i = 0; i < S * S; ++i)
    for (int c = 0; c < 3; ++c) img[i * 3 + c] = lut[c * 256 + img[i * 3 + c]];
}

void op_autocontrast(uint8_t* img, int S) {
  uint8_t lut[3 * 256];
  for (int c = 0; c < 3; ++c) {
    int lo = 255, hi = 0;
    for (int i = 0; i < S * S; ++i) {
      int v = img[i * 3 + c];
      if (v < lo) lo = v;
      if (v > hi) hi = v;
    }
    if (hi <= lo) {
      for (int i = 0; i < 256; ++i) lut[c * 256 + i] = uint8_t(i);
      continue;
    }
    // PIL ImageOps.autocontrast lut math in Python doubles (truncation).
    double scale = 255.0 / (hi - lo);
    double offset = -lo * scale;
    for (int i = 0; i < 256; ++i) {
      int v = int(i * scale + offset);
      lut[c * 256 + i] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  op_lut(img, S, lut);
}

void op_equalize(uint8_t* img, int S) {
  // PIL ImageOps.equalize: lut[i] = (step//2 + excl_cumsum(h)[i]) // step,
  // step = (pixels - h[last_nonzero]) // 255; identity when step == 0 or
  // the channel has <= 1 distinct value. Integer math → exact.
  uint8_t lut[3 * 256];
  for (int c = 0; c < 3; ++c) {
    long h[256] = {0};
    for (int i = 0; i < S * S; ++i) ++h[img[i * 3 + c]];
    int last_nz = -1, nz = 0;
    for (int i = 0; i < 256; ++i)
      if (h[i]) {
        last_nz = i;
        ++nz;
      }
    long step = nz > 1 ? (long(S) * S - h[last_nz]) / 255 : 0;
    if (step == 0) {
      for (int i = 0; i < 256; ++i) lut[c * 256 + i] = uint8_t(i);
      continue;
    }
    long n = step / 2;
    for (int i = 0; i < 256; ++i) {
      long v = n / step;
      lut[c * 256 + i] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
      n += h[i];
    }
  }
  op_lut(img, S, lut);
}

void op_invert(uint8_t* img, int S) {
  for (int i = 0; i < S * S * 3; ++i) img[i] = uint8_t(255 - img[i]);
}

void op_posterize(uint8_t* img, int S, int bits) {
  uint8_t mask = uint8_t(~((1 << (8 - bits)) - 1));
  for (int i = 0; i < S * S * 3; ++i) img[i] = uint8_t(img[i] & mask);
}

void op_solarize(uint8_t* img, int S, int threshold) {
  for (int i = 0; i < S * S * 3; ++i)
    if (img[i] >= threshold) img[i] = uint8_t(255 - img[i]);
}

void op_brightness(uint8_t* img, int S, float f) {
  // ImageEnhance.Brightness: blend toward black; PIL blend truncates.
  for (int i = 0; i < S * S * 3; ++i)
    img[i] = clip_trunc(f * float(img[i]));
}

inline uint8_t luma(const uint8_t* p) {
  // PIL RGB->L: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.
  return uint8_t(
      (uint32_t(p[0]) * 19595 + uint32_t(p[1]) * 38470 + uint32_t(p[2]) * 7471 +
       0x8000) >> 16);
}

void op_color(uint8_t* img, int S, float f) {
  // ImageEnhance.Color: blend toward the grayscale (L) image.
  for (int i = 0; i < S * S; ++i) {
    uint8_t* p = img + i * 3;
    float l = float(luma(p));
    for (int c = 0; c < 3; ++c) p[c] = clip_trunc(l + f * (float(p[c]) - l));
  }
}

void op_contrast(uint8_t* img, int S, float f) {
  // ImageEnhance.Contrast: blend toward flat gray at round(mean(L)).
  double sum = 0;
  for (int i = 0; i < S * S; ++i) sum += luma(img + i * 3);
  float mean = float(long(sum / (double(S) * S) + 0.5));
  for (int i = 0; i < S * S * 3; ++i)
    img[i] = clip_trunc(mean + f * (float(img[i]) - mean));
}

void op_sharpness(uint8_t* img, int S, float f, uint8_t* tmp) {
  // ImageEnhance.Sharpness: blend toward SMOOTH-filtered image
  // (3x3 [[1,1,1],[1,5,1],[1,1,1]]/13; PIL leaves the 1-px border as-is).
  memcpy(tmp, img, size_t(S) * S * 3);
  for (int y = 1; y < S - 1; ++y)
    for (int x = 1; x < S - 1; ++x)
      for (int c = 0; c < 3; ++c) {
        int acc = 5 * tmp[(y * S + x) * 3 + c];
        acc += tmp[((y - 1) * S + x - 1) * 3 + c];
        acc += tmp[((y - 1) * S + x) * 3 + c];
        acc += tmp[((y - 1) * S + x + 1) * 3 + c];
        acc += tmp[(y * S + x - 1) * 3 + c];
        acc += tmp[(y * S + x + 1) * 3 + c];
        acc += tmp[((y + 1) * S + x - 1) * 3 + c];
        acc += tmp[((y + 1) * S + x) * 3 + c];
        acc += tmp[((y + 1) * S + x + 1) * 3 + c];
        float smooth = float(acc) / 13.0f;
        if (smooth < 0) smooth = 0;
        if (smooth > 255) smooth = 255;
        img[(y * S + x) * 3 + c] =
            clip_trunc(smooth + f * (float(tmp[(y * S + x) * 3 + c]) - smooth));
      }
  // border: degenerate == original → blend is identity there.
}

// Inverse-affine bilinear warp, PIL conventions (pixel-center +0.5 offsets,
// gray fill for source positions outside [0,W)x[0,H) in pre -0.5 space,
// border-clamped taps). Writes img from tmp (tmp = source copy).
void op_affine(uint8_t* img, int S, const double m[6], uint8_t* tmp) {
  memcpy(tmp, img, size_t(S) * S * 3);
  for (int y = 0; y < S; ++y)
    for (int x = 0; x < S; ++x) {
      double xc = m[0] * (x + 0.5) + m[1] * (y + 0.5) + m[2];
      double yc = m[3] * (x + 0.5) + m[4] * (y + 0.5) + m[5];
      uint8_t* dst = img + (size_t(y) * S + x) * 3;
      if (xc < 0 || xc >= S || yc < 0 || yc >= S) {
        dst[0] = dst[1] = dst[2] = kFill;
        continue;
      }
      double xs = xc - 0.5, ys = yc - 0.5;
      int x0 = int(floor(xs)), y0 = int(floor(ys));
      double wx = xs - x0, wy = ys - y0;
      int x0c = x0 < 0 ? 0 : (x0 > S - 1 ? S - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 > S - 1 ? S - 1 : x0 + 1);
      int y0c = y0 < 0 ? 0 : (y0 > S - 1 ? S - 1 : y0);
      int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 > S - 1 ? S - 1 : y0 + 1);
      for (int c = 0; c < 3; ++c) {
        double v00 = tmp[(size_t(y0c) * S + x0c) * 3 + c];
        double v01 = tmp[(size_t(y0c) * S + x1c) * 3 + c];
        double v10 = tmp[(size_t(y1c) * S + x0c) * 3 + c];
        double v11 = tmp[(size_t(y1c) * S + x1c) * 3 + c];
        double v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                   wy * ((1 - wx) * v10 + wx * v11);
        dst[c] = uint8_t(v + 0.5 < 0 ? 0 : (v + 0.5 > 255 ? 255 : v + 0.5));
      }
    }
}

void apply_randaug_op(uint8_t* img, int S, int code, float sign, float m,
                      uint8_t* tmp) {
  const float shear = (m / kMaxLevel) * 0.3f;
  const float rot = (m / kMaxLevel) * 30.0f;
  const float enh = (m / kMaxLevel) * 1.8f + 0.1f;
  const double t = double(int((m / kMaxLevel) * (S / 3)));
  double mat[6] = {1, 0, 0, 0, 1, 0};
  switch (code) {
    case OP_IDENTITY:
      return;
    case OP_AUTOCONTRAST:
      op_autocontrast(img, S);
      return;
    case OP_EQUALIZE:
      op_equalize(img, S);
      return;
    case OP_BRIGHTNESS:
      op_brightness(img, S, enh);
      return;
    case OP_SHARPNESS:
      op_sharpness(img, S, enh, tmp);
      return;
    case OP_INVERT:
      op_invert(img, S);
      return;
    case OP_POSTERIZE: {
      int bits = 8 - int((m / kMaxLevel) * 4);
      op_posterize(img, S, bits < 1 ? 1 : bits);
      return;
    }
    case OP_SOLARIZE:
      op_solarize(img, S, 256 - int((m / kMaxLevel) * 256));
      return;
    case OP_COLOR:
      op_color(img, S, enh);
      return;
    case OP_CONTRAST:
      op_contrast(img, S, enh);
      return;
    case OP_SHEARX:
      mat[1] = sign * shear;
      break;
    case OP_SHEARY:
      mat[3] = sign * shear;
      break;
    case OP_TRANSLATEX:
      mat[2] = sign * t;
      break;
    case OP_TRANSLATEY:
      mat[5] = sign * t;
      break;
    case OP_ROTATE: {
      // PIL Image.rotate: inverse matrix from -radians about the center.
      double th = -double(sign * rot) * 3.14159265358979323846 / 180.0;
      double a = cos(th), b = sin(th);
      double cx = S / 2.0, cy = S / 2.0;
      mat[0] = a;
      mat[1] = b;
      mat[2] = cx - (a * cx + b * cy);
      mat[3] = -b;
      mat[4] = a;
      mat[5] = cy - (-b * cx + a * cy);
      break;
    }
    default:
      return;
  }
  op_affine(img, S, mat, tmp);
}

}  // namespace

extern "C" {

// Threaded in-place RandAugment over a [n, size, size, 3] uint8 batch.
// codes/signs: [n, max_ops] per-image planned ops (code -1 = end of plan,
// matching data/randaugment.RandomAugment.plan); m = magnitude (M=7 scale).
int xfm_randaugment_batch(uint8_t* imgs, int n, int size, const int* codes,
                          const float* signs, int max_ops, float m,
                          int threads) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  std::atomic<int> next(0);
  const size_t stride = size_t(size) * size * 3;
  auto worker = [&]() {
    std::vector<uint8_t> tmp(stride);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* img = imgs + stride * i;
      for (int k = 0; k < max_ops; ++k) {
        int code = codes[i * max_ops + k];
        if (code < 0) break;
        apply_randaug_op(img, size, code, signs[i * max_ops + k], m,
                         tmp.data());
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"

extern "C" {

// Dimensions of an image by its full decode (so a broken body fails).
// Returns 0 on success.
int xfm_image_dims(const uint8_t* data, long len, int* w, int* h) {
  Image img;
  if (!decode_any(data, len, &img)) return 1;
  *w = img.w;
  *h = img.h;
  return 0;
}

// Header-only dimensions: JPEG SOF marker scan / PNG IHDR parse — no pixel
// decode, so it is a cheap validity+size probe for batch admission.
// Returns 0 on success.
int xfm_image_dims_fast(const uint8_t* data, long len, int* w, int* h) {
  return dims_fast_impl(data, len, w, h);
}

}  // extern "C"

namespace {

int dims_fast_impl(const uint8_t* data, long len, int* w, int* h) {
  if (len > 3 && data[0] == 0xFF && data[1] == 0xD8) {  // JPEG
    long i = 2;
    while (i + 9 < len) {
      if (data[i] != 0xFF) return 1;
      uint8_t marker = data[i + 1];
      if (marker == 0xFF) { ++i; continue; }
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD9)) {
        i += 2;
        continue;  // standalone markers
      }
      long seglen = (long(data[i + 2]) << 8) | data[i + 3];
      if (seglen < 2 || i + 2 + seglen > len) return 1;
      // SOF0-SOF15 except DHT(C4)/JPG(C8)/DAC(CC)
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
          marker != 0xC8 && marker != 0xCC) {
        if (seglen < 7) return 1;
        *h = (int(data[i + 5]) << 8) | data[i + 6];
        *w = (int(data[i + 7]) << 8) | data[i + 8];
        return (*w > 0 && *h > 0) ? 0 : 1;
      }
      i += 2 + seglen;
    }
    return 1;
  }
  if (len > 24 && data[0] == 0x89 && data[1] == 'P') {  // PNG IHDR
    *w = (int(data[16]) << 24) | (int(data[17]) << 16) |
         (int(data[18]) << 8) | int(data[19]);
    *h = (int(data[20]) << 24) | (int(data[21]) << 16) |
         (int(data[22]) << 8) | int(data[23]);
    return (*w > 0 && *h > 0) ? 0 : 1;
  }
  return 1;
}

}  // namespace

extern "C" {

// Threaded batch: datas[i]/lens[i] are encoded images, crops is [B*4]
// (x,y,w,h per image; w<=0 = full frame), hflips is [B]. out is
// [B, out_size, out_size, 3] uint8. Returns the number of failed images;
// a failed slot is zero-filled and, where `status` is non-null, marked 1
// there (0 for a decoded one), so that callers can substitute it.
int xfm_decode_batch_status(const uint8_t** datas, const long* lens,
                            const int* crops, int out_size,
                            const int* hflips, uint8_t* out, int n,
                            int threads, int* status) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  std::atomic<int> next(0), failed(0);
  const size_t stride = size_t(out_size) * out_size * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      // DCT-domain scaled JPEG decode when the crop is >= 2x the output:
      // the final bilinear stays a downscale; ~denom^2 less IDCT work.
      int denom = pick_scale_denom(datas[i], lens[i], crops + 4 * i,
                                   out_size);
      if (!decode_any(datas[i], lens[i], &img, denom)) {
        memset(out + stride * i, 0, stride);
        if (status) status[i] = 1;
        failed.fetch_add(1);
        continue;
      }
      if (status) status[i] = 0;
      int sc[4];
      scale_crop(img, crops + 4 * i, sc);
      crop_resize(img, sc[0], sc[1], sc[2], sc[3], out_size, hflips[i],
                  out + stride * i);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failed.load();
}

}  // extern "C"

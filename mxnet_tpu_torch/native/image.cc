// JPEG/PNG decode + bilinear resize for the native data path.
//
// Replaces the reference's OpenCV dependency in the IO hot loop
// (src/io/image_io.cc imdecode, image_aug_default.cc resize) with direct
// libjpeg/libpng decode into HWC uint8.
#include "mxnative.h"

#include <csetjmp>
#include <cstdio>  // jpeglib.h needs FILE declared first
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- jpeg
struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void JerrExit(j_common_ptr cinfo) {
  JerrMgr* e = reinterpret_cast<JerrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

int DecodeJpeg(const uint8_t* buf, int64_t len, int channels, uint8_t** out,
               int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JerrExit;
  // volatile: written between setjmp and longjmp, read in the handler
  uint8_t* volatile data = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(data);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  // CMYK/YCCK (Adobe) can't be converted to RGB by libjpeg itself;
  // decode as CMYK and convert below (the cv2 path handles these too).
  bool cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
              cinfo.jpeg_color_space == JCS_YCCK;
  if (cmyk) cinfo.out_color_space = JCS_CMYK;
  else if (channels == 1) cinfo.out_color_space = JCS_GRAYSCALE;
  else if (channels == 3) cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int W = cinfo.output_width, H = cinfo.output_height,
      C = cinfo.output_components;
  data = static_cast<uint8_t*>(std::malloc((size_t)W * H * C));
  if (!data) longjmp(jerr.jb, 1);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = data + (size_t)cinfo.output_scanline * W * C;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  uint8_t* result = data;
  int outC = C;
  if (cmyk) {  // libjpeg yields inverted CMYK: rgb = cmy * k / 255
    int want = channels == 1 ? 1 : 3;
    uint8_t* rgb = static_cast<uint8_t*>(std::malloc((size_t)W * H * want));
    if (!rgb) {
      std::free(data);
      return -1;
    }
    for (int64_t i = 0; i < (int64_t)W * H; ++i) {
      const uint8_t* p = result + i * 4;
      int r = p[0] * p[3] / 255, g = p[1] * p[3] / 255,
          b = p[2] * p[3] / 255;
      if (want == 1) {
        rgb[i] = static_cast<uint8_t>((299 * r + 587 * g + 114 * b) / 1000);
      } else {
        rgb[i * 3] = static_cast<uint8_t>(r);
        rgb[i * 3 + 1] = static_cast<uint8_t>(g);
        rgb[i * 3 + 2] = static_cast<uint8_t>(b);
      }
    }
    std::free(data);
    result = rgb;
    outC = want;
  }
  *out = result;
  *h = H;
  *w = W;
  *c = outC;
  return 0;
}

// ---------------------------------------------------------------- png
struct PngReadState {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;
};

void PngRead(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + static_cast<int64_t>(n) > s->len)
    png_error(png, "png: read past end");
  std::memcpy(out, s->buf + s->pos, n);
  s->pos += n;
}

int DecodePng(const uint8_t* buf, int64_t len, int channels, uint8_t** out,
              int* h, int* w, int* c) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  // volatile: written between setjmp and longjmp, read in the handler
  uint8_t* volatile data = nullptr;
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::free(data);
    return -1;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, PngRead);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_packing(png);
  png_set_strip_alpha(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (channels == 3 &&
      (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA))
    png_set_gray_to_rgb(png);
  if (channels == 1 && color != PNG_COLOR_TYPE_GRAY &&
      color != PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_rgb_to_gray(png, 1, -1, -1);
  png_read_update_info(png, info);
  int W = png_get_image_width(png, info), H = png_get_image_height(png, info);
  int C = png_get_channels(png, info);
  data = static_cast<uint8_t*>(std::malloc((size_t)W * H * C));
  if (!data) png_error(png, "png: oom");
  std::vector<png_bytep> rows(H);
  for (int y = 0; y < H; ++y) rows[y] = data + (size_t)y * W * C;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *out = data;
  *h = H;
  *w = W;
  *c = C;
  return 0;
}

}  // namespace

extern "C" {

int mximg_decode(const uint8_t* buf, int64_t len, int channels, uint8_t** out,
                 int* h, int* w, int* c) {
  if (len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF)
    return DecodeJpeg(buf, len, channels, out, h, w, c);
  if (len >= 8 && std::memcmp(buf, "\x89PNG\r\n\x1a\n", 8) == 0)
    return DecodePng(buf, len, channels, out, h, w, c);
  return -2;  // unknown format
}

void mximg_free(uint8_t* buf) { std::free(buf); }

void mximg_resize(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                  int dh, int dw) {
  // Bilinear with half-pixel centers (matches cv2.resize INTER_LINEAR).
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      const uint8_t* p00 = src + ((size_t)y0 * sw + x0) * c;
      const uint8_t* p01 = src + ((size_t)y0 * sw + x1) * c;
      const uint8_t* p10 = src + ((size_t)y1 * sw + x0) * c;
      const uint8_t* p11 = src + ((size_t)y1 * sw + x1) * c;
      uint8_t* d = dst + ((size_t)y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float v = (1 - wy) * ((1 - wx) * p00[k] + wx * p01[k]) +
                  wy * ((1 - wx) * p10[k] + wx * p11[k]);
        d[k] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // extern "C"

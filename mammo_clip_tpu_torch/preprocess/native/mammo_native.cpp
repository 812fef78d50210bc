// Native offline-preprocessing kernels (host code; a copy of
// mammo_clip_tpu/preprocess/native/mammo_native.cpp plus the PNG row unfilter).
//
// The reference leans on native third-party code for its offline pipeline: dicomsdl
// for pixel decode, OpenCV for INTER_AREA resize, NVIDIA DALI for GPU JPEG2000
// (reference: src/preprocessing/preprocess_image_to_png_{vindr,kaggle}.py; SURVEY.md
// §2.3). This library provides first-party equivalents of the compute stages —
// window/normalize, breast-ROI crop, area resize, CLAHE — and the PNG row
// unfilter of data/png.py, as a small C ABI consumed via ctypes
// (preprocess/native_bindings.py, which also holds a plain numpy version of each).
//
// Built at first use by preprocess/native_bindings.py (g++ -O3 -shared -fPIC
// -std=c++17) into mammo_clip_tpu_torch/build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// min-max normalize a uint16 pixel buffer to uint8, optionally inverting
// (MONOCHROME1), matching preprocess_image_to_png_vindr.py:84-90.
void normalize_u16_to_u8(const uint16_t* src, int64_t n, int invert, uint8_t* dst) {
  if (n <= 0) return;
  uint16_t lo = src[0], hi = src[0];
  for (int64_t i = 1; i < n; ++i) {
    lo = std::min(lo, src[i]);
    hi = std::max(hi, src[i]);
  }
  const float denom = hi > lo ? 1.0f / float(hi - lo) : 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    float v = float(src[i] - lo) * denom;
    if (invert) v = 1.0f - v;
    dst[i] = uint8_t(v * 255.0f + 0.5f);
  }
}

namespace {

// longest run of true values -> [start, end)
inline void longest_run(const std::vector<uint8_t>& mask, int* start, int* end) {
  int best_s = 0, best_len = 0, cur_s = -1;
  const int n = int(mask.size());
  for (int i = 0; i <= n; ++i) {
    const bool v = i < n && mask[i];
    if (v && cur_s < 0) cur_s = i;
    if (!v && cur_s >= 0) {
      if (i - cur_s > best_len) { best_s = cur_s; best_len = i - cur_s; }
      cur_s = -1;
    }
  }
  *start = best_s;
  *end = best_s + best_len;
}

// column/row is "breast" when its central band is non-constant (std != 0), after
// zeroing background (<= thresh) — preprocess_image_to_png_vindr.py:55-76.
inline void variance_mask_cols(const uint8_t* img, int h, int w, int y0, int y1,
                               int x0, int x1, int thresh, bool cols,
                               std::vector<uint8_t>* mask) {
  const int outer = cols ? (x1 - x0) : (y1 - y0);
  mask->assign(outer, 0);
  for (int o = 0; o < outer; ++o) {
    int first = -1;
    bool varying = false;
    const int inner_n = cols ? (y1 - y0) : (x1 - x0);
    for (int i = 0; i < inner_n; ++i) {
      const int y = cols ? (y0 + i) : (y0 + o);
      const int x = cols ? (x0 + o) : (x0 + i);
      int v = img[int64_t(y) * w + x];
      if (v <= thresh) v = 0;
      if (first < 0) first = v;
      else if (v != first) { varying = true; break; }
    }
    (*mask)[o] = varying ? 1 : 0;
  }
}

}  // namespace

// breast ROI bounds (y0, y1, x0, x1) of an (h, w) uint8 image.
void breast_crop_bounds(const uint8_t* img, int h, int w, int thresh, int* out) {
  std::vector<uint8_t> mask;
  const int band_y0 = h / 2 - int(h * 0.4), band_y1 = h / 2 + int(h * 0.4);
  variance_mask_cols(img, h, w, band_y0, band_y1, 0, w, thresh, /*cols=*/true, &mask);
  int x0, x1;
  longest_run(mask, &x0, &x1);
  if (x1 <= x0) { x0 = 0; x1 = w; }

  const int bw = x1 - x0;
  const int band_x0 = x0 + std::max(bw / 2 - int(bw * 0.4), 0);
  const int band_x1 = x0 + bw / 2 + int(bw * 0.4);
  variance_mask_cols(img, h, w, 0, h, band_x0, band_x1, thresh, /*cols=*/false, &mask);
  int y0, y1;
  longest_run(mask, &y0, &y1);
  if (y1 <= y0) { y0 = 0; y1 = h; }
  out[0] = y0; out[1] = y1; out[2] = x0; out[3] = x1;
}

// area-weighted (box-filter) downscale/upscale, equivalent to cv2 INTER_AREA for
// downscaling (preprocess_image_to_png_vindr.py:91). Separable two-pass.
void area_resize_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
  std::vector<float> tmp(int64_t(sh) * dw);
  const float sx = float(sw) / dw;
  // horizontal pass
  for (int x = 0; x < dw; ++x) {
    const float a = x * sx, b = (x + 1) * sx;
    const int ia = int(a), ib = std::min(int(b - 1e-6f), sw - 1);
    for (int y = 0; y < sh; ++y) {
      float acc = 0.0f, wsum = 0.0f;
      for (int i = ia; i <= ib; ++i) {
        const float l = std::max(a, float(i)), r = std::min(b, float(i + 1));
        const float wgt = r - l;
        acc += wgt * src[int64_t(y) * sw + i];
        wsum += wgt;
      }
      tmp[int64_t(y) * dw + x] = acc / wsum;
    }
  }
  // vertical pass
  const float sy = float(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    const float a = y * sy, b = (y + 1) * sy;
    const int ia = int(a), ib = std::min(int(b - 1e-6f), sh - 1);
    for (int x = 0; x < dw; ++x) {
      float acc = 0.0f, wsum = 0.0f;
      for (int i = ia; i <= ib; ++i) {
        const float l = std::max(a, float(i)), r = std::min(b, float(i + 1));
        const float wgt = r - l;
        acc += wgt * tmp[int64_t(i) * dw + x];
        wsum += wgt;
      }
      dst[int64_t(y) * dw + x] = uint8_t(std::min(std::max(acc / wsum, 0.0f), 255.0f) + 0.5f);
    }
  }
}

// fused pipeline: normalize -> crop -> resize, one call per image
// (the hot path of the offline tool; returns crop bounds for box remapping).
void preprocess_mammogram_u16(const uint16_t* raw, int h, int w, int invert,
                              int crop_thresh, uint8_t* out, int out_h, int out_w,
                              int* crop_bounds) {
  std::vector<uint8_t> norm(int64_t(h) * w);
  normalize_u16_to_u8(raw, int64_t(h) * w, invert, norm.data());
  breast_crop_bounds(norm.data(), h, w, crop_thresh, crop_bounds);
  const int y0 = crop_bounds[0], y1 = crop_bounds[1];
  const int x0 = crop_bounds[2], x1 = crop_bounds[3];
  const int ch = y1 - y0, cw = x1 - x0;
  std::vector<uint8_t> cropped(int64_t(ch) * cw);
  for (int y = 0; y < ch; ++y)
    std::memcpy(&cropped[int64_t(y) * cw], &norm[int64_t(y0 + y) * w + x0], cw);
  area_resize_u8(cropped.data(), ch, cw, out, out_h, out_w);
}

}  // extern "C"

extern "C" {

// Contrast-limited adaptive histogram equalization (CLAHE), matching OpenCV's
// algorithm (tile histograms -> clip + uniform excess redistribution -> CDF LUTs
// -> bilinear LUT interpolation). The reference's transform config is literally
// named "clahe.yaml" but never applies CLAHE (configs/transform/clahe.yaml);
// this makes the op actually available for offline preprocessing experiments.
// h, w need not be divisible by the tile grid (edge tiles are larger, like cv2's
// border extension in effect).
void clahe_u8(const uint8_t* src, int h, int w, int tiles_y, int tiles_x,
              float clip_limit, uint8_t* dst) {
  tiles_y = std::max(1, tiles_y);
  tiles_x = std::max(1, tiles_x);
  const int th = (h + tiles_y - 1) / tiles_y;
  const int tw = (w + tiles_x - 1) / tiles_x;
  std::vector<float> luts(size_t(tiles_y) * tiles_x * 256);

  for (int ty = 0; ty < tiles_y; ++ty) {
    for (int tx = 0; tx < tiles_x; ++tx) {
      const int y0 = ty * th, y1 = std::min(y0 + th, h);
      const int x0 = tx * tw, x1 = std::min(x0 + tw, w);
      const int area = (y1 - y0) * (x1 - x0);
      int hist[256] = {0};
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x) ++hist[src[int64_t(y) * w + x]];
      // clip + redistribute (cv2: clip value scales with tile area)
      const int clip = std::max(1, int(clip_limit * area / 256.0f));
      int excess = 0;
      for (int i = 0; i < 256; ++i) {
        if (hist[i] > clip) { excess += hist[i] - clip; hist[i] = clip; }
      }
      const int bonus = excess / 256, rem = excess % 256;
      for (int i = 0; i < 256; ++i) hist[i] += bonus + (i < rem ? 1 : 0);
      // CDF -> LUT
      float* lut = &luts[(size_t(ty) * tiles_x + tx) * 256];
      int cdf = 0;
      const float scale = 255.0f / float(area);
      for (int i = 0; i < 256; ++i) {
        cdf += hist[i];
        lut[i] = scale * cdf;
      }
    }
  }

  // bilinear interpolation between the four surrounding tile LUTs
  for (int y = 0; y < h; ++y) {
    const float fy = (float(y) - th / 2.0f + 0.5f) / th;
    int ty0 = int(std::floor(fy));
    const float wy = fy - ty0;
    int ty1 = std::min(std::max(ty0 + 1, 0), tiles_y - 1);
    ty0 = std::min(std::max(ty0, 0), tiles_y - 1);
    for (int x = 0; x < w; ++x) {
      const float fx = (float(x) - tw / 2.0f + 0.5f) / tw;
      int tx0 = int(std::floor(fx));
      const float wx = fx - tx0;
      int tx1 = std::min(std::max(tx0 + 1, 0), tiles_x - 1);
      tx0 = std::min(std::max(tx0, 0), tiles_x - 1);
      const int v = src[int64_t(y) * w + x];
      const float v00 = luts[(size_t(ty0) * tiles_x + tx0) * 256 + v];
      const float v01 = luts[(size_t(ty0) * tiles_x + tx1) * 256 + v];
      const float v10 = luts[(size_t(ty1) * tiles_x + tx0) * 256 + v];
      const float v11 = luts[(size_t(ty1) * tiles_x + tx1) * 256 + v];
      const float top = v00 * (1 - wx) + v01 * wx;
      const float bot = v10 * (1 - wx) + v11 * wx;
      const float out = top * (1 - wy) + bot * wy;
      dst[int64_t(y) * w + x] = uint8_t(std::min(std::max(out, 0.0f), 255.0f) + 0.5f);
    }
  }
}

}  // extern "C"

extern "C" {

// Undo the PNG row filters (PNG spec §9) of h scanlines, each a filter-type
// byte followed by `stride` bytes, with `bpp` bytes per complete pixel. Writes
// h * stride bytes to dst. Returns 0, or 1 + the index of the first row whose
// filter type is not 0-4.
int png_unfilter(const uint8_t* src, int h, int stride, int bpp, uint8_t* dst) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = src + int64_t(y) * (stride + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + int64_t(y) * stride;
    const uint8_t* up = y > 0 ? out - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(out, in, size_t(stride));
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          out[i] = uint8_t(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) out[i] = uint8_t(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          out[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (i >= bpp && up) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = uint8_t(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"

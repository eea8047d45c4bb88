// ppst_io: the loader's native image kernels (the port's copy of the JAX
// package's native/ppst_io.cpp, the same code).
//
// Bilinear and nearest resize of HWC uint8 images, the [-1, 1] float
// conversion with an optional horizontal flip, and the one-hot of a label
// mask, called from the loader's threads through ctypes
// (ppst_tpu_torch/data/native.py). They hold no Python state, so the
// threads run them in parallel; each also runs its rows on OpenMP.
//
// Built at first use by ppst_tpu_torch/data/native.py with
// g++ -O3 -march=native -fopenmp -shared -fPIC into ppst_tpu_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Bilinear resize HWC uint8 -> HWC uint8 (half-pixel centers, matching
// PIL/torch antialias-off semantics closely enough for training data).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  const float ry = (float)sh / dh;
  const float rx = (float)sw / dw;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ry - 0.5f;
    int y0 = (int)fy;
    if (fy < 0) { fy = 0; y0 = 0; }
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * rx - 0.5f;
      int x0 = (int)fx;
      if (fx < 0) { fx = 0; x0 = 0; }
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      uint8_t* out = dst + (y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float top = p00[k] + (p01[k] - p00[k]) * wx;
        float bot = p10[k] + (p11[k] - p10[k]) * wx;
        out[k] = (uint8_t)(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

// Nearest resize (for label masks).
void resize_nearest_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  const float ry = (float)sh / dh;
  const float rx = (float)sw / dw;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    int sy = std::min((int)((y + 0.5f) * ry), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int sx = std::min((int)((x + 0.5f) * rx), sw - 1);
      std::memcpy(dst + (y * dw + x) * c, src + (sy * sw + sx) * c, c);
    }
  }
}

// HWC uint8 -> HWC float32 in [-1, 1], optional horizontal flip.
void u8_to_pm1_f32(const uint8_t* src, int h, int w, int c, int flip,
                   float* dst) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int sx = flip ? (w - 1 - x) : x;
      const uint8_t* p = src + (y * w + sx) * c;
      float* o = dst + (y * w + x) * c;
      for (int k = 0; k < c; ++k) o[k] = p[k] * (2.0f / 255.0f) - 1.0f;
    }
  }
}

// HW uint8 label map -> HWC float32 one-hot over num_classes, optional
// horizontal flip.
void labels_to_onehot_f32(const uint8_t* src, int h, int w, int num_classes,
                          int flip, float* dst) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int sx = flip ? (w - 1 - x) : x;
      int lbl = src[y * w + sx];
      float* o = dst + (y * w + x) * num_classes;
      for (int k = 0; k < num_classes; ++k) o[k] = 0.0f;
      if (lbl < num_classes) o[lbl] = 1.0f;
    }
  }
}

}  // extern "C"

// Parallel DICOM decode+preprocess pool (a copy of mammo_clip_tpu/preprocess/
// native/mammo_pool.cpp).
//
// The reference gets offline decode parallelism from NVIDIA DALI's GPU JPEG2000
// pipeline (reference: src/preprocessing/preprocess_image_to_png_kaggle.py:95-100)
// and from launching many python processes. This is the host-side equivalent: a
// std::thread pool over the first-party GDCM codec (mammo_dicom.cpp) fused with
// the native normalize/crop/resize kernels (mammo_native.cpp), so one call
// converts a batch of DICOMs using every host core, with zero Python in the loop.
//
// Thread-safety: each task uses its own gdcm::ImageReader via dicom_read_u16;
// GDCM's global dictionaries are lazily initialized, so the batch decodes
// paths[0] serially first to warm that static state before spinning workers.
//
// Built at first use by preprocess/dicom_native.py into one library with
// mammo_dicom.cpp and mammo_native.cpp, which define the functions below.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {
// from mammo_dicom.cpp
int dicom_image_info(const char* path, int64_t* rows, int64_t* cols,
                     int* bits_allocated, int* is_signed, int* monochrome1);
int dicom_read_u16(const char* path, uint16_t* out, int64_t out_elems);
// from mammo_native.cpp
void preprocess_mammogram_u16(const uint16_t* raw, int h, int w, int invert,
                              int crop_thresh, uint8_t* out, int out_h, int out_w,
                              int* crop_bounds);
}

namespace {

// one DICOM -> preprocessed uint8 tile; mirrors dicom_tool.convert_one's native
// path including the 5-pixel edge trim (burned-in annotations at frame edges).
int convert_one(const char* path, int out_h, int out_w, int crop_thresh, int trim,
                uint8_t* out, int* bounds) {
  int64_t rows = 0, cols = 0;
  int bits = 0, sgn = 0, mono1 = 0;
  int rc = dicom_image_info(path, &rows, &cols, &bits, &sgn, &mono1);
  if (rc != 0) return rc;
  std::vector<uint16_t> raw(size_t(rows) * cols);
  rc = dicom_read_u16(path, raw.data(), int64_t(rows) * cols);
  if (rc != 0) return rc;

  const int t = (rows > 2 * trim && cols > 2 * trim) ? trim : 0;
  const int th = int(rows) - 2 * t, tw = int(cols) - 2 * t;
  std::vector<uint16_t> trimmed(size_t(th) * tw);
  for (int y = 0; y < th; ++y)
    for (int x = 0; x < tw; ++x)
      trimmed[size_t(y) * tw + x] = raw[size_t(y + t) * cols + (x + t)];

  preprocess_mammogram_u16(trimmed.data(), th, tw, mono1, crop_thresh, out,
                           out_h, out_w, bounds);
  return 0;
}

}  // namespace

extern "C" {

// Convert n DICOMs in parallel. out: (n, out_h, out_w) uint8; bounds: (n, 4)
// int32 crop rectangles in the TRIMMED frame (y0, y1, x0, x1); status: (n,)
// int32 per-file Status codes (mammo_dicom.cpp enum). Returns the number of
// failures (0 = all converted). n_threads <= 0 -> hardware concurrency.
int dicom_batch_preprocess(const char* const* paths, int n, int out_h, int out_w,
                           int crop_thresh, int trim, int n_threads,
                           uint8_t* out, int32_t* bounds, int32_t* status) {
  if (n <= 0) return 0;
  const int64_t tile = int64_t(out_h) * out_w;

  // Serial warm-up: decode until one file SUCCEEDS — only a successful decode
  // is guaranteed to have initialized GDCM's lazily-created global
  // dictionaries. A failed first file (open/preamble error) can bail before
  // touching them, which would hand the static-init race to the workers.
  int warm = 0, warm_failures = 0;
  while (warm < n) {
    int b0[4];
    const int rc = convert_one(paths[warm], out_h, out_w, crop_thresh, trim,
                               out + int64_t(warm) * tile, b0);
    status[warm] = rc;
    for (int k = 0; k < 4; ++k) bounds[int64_t(warm) * 4 + k] = b0[k];
    ++warm;
    if (rc == 0) break;
    ++warm_failures;
  }
  if (warm >= n) return warm_failures;

  int hw = int(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  n_threads = std::min(n_threads, n - warm);

  std::atomic<int> next(warm), failures(warm_failures);
  auto worker = [&]() {
    int b[4];
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      const int rc =
          convert_one(paths[i], out_h, out_w, crop_thresh, trim,
                      out + int64_t(i) * tile, b);
      status[i] = rc;
      for (int k = 0; k < 4; ++k) bounds[int64_t(i) * 4 + k] = b[k];
      if (rc != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(size_t(n_threads));
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"

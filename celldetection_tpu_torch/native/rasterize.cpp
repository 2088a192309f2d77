// Native contour rasterizer: scanline polygon fill for label images.
//
// The port's copy of celldetection_tpu/native/rasterize.cpp. It replaces the
// per-contour Python loop of ``contours2labels`` (the reference's
// ``celldetection/data/cpn.py:292, :811``) with a single C++ pass.
//
// Exposed via ctypes (see celldetection_tpu_torch/native/__init__.py):
//   rasterize_labels(contours, offsets, counts, n_contours, h, w, out)
//   rasterize_labels_mt(..., num_threads)
//
// Each contour is filled into the int32 label canvas with value = index + 1
// using even-odd scanline filling. The sequential variant processes contours
// in order (later contours overwrite earlier ones — last-wins overlap
// flattening); the multithreaded variant partitions contours across threads
// (any-wins on overlap).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

void fill_one(const double* pts, int64_t n, int32_t val, int64_t height,
              int64_t width, int32_t* labels_out, std::vector<double>& xs) {
  if (n < 3) {
    for (int64_t k = 0; k < n; ++k) {
      int64_t x = llround(pts[k * 2]);
      int64_t y = llround(pts[k * 2 + 1]);
      if (x >= 0 && x < width && y >= 0 && y < height)
        labels_out[y * width + x] = val;
    }
    return;
  }
  double ymin = pts[1], ymax = pts[1];
  for (int64_t k = 1; k < n; ++k) {
    ymin = std::min(ymin, pts[k * 2 + 1]);
    ymax = std::max(ymax, pts[k * 2 + 1]);
  }
  const int64_t y0 = std::max<int64_t>(0, llround(std::floor(ymin)));
  const int64_t y1 = std::min<int64_t>(height - 1, llround(std::ceil(ymax)));
  for (int64_t y = y0; y <= y1; ++y) {
    const double yc = static_cast<double>(y);
    xs.clear();
    for (int64_t k = 0; k < n; ++k) {
      const int64_t k2 = (k + 1) % n;
      const double ax = pts[k * 2], ay = pts[k * 2 + 1];
      const double bx = pts[k2 * 2], by = pts[k2 * 2 + 1];
      if ((ay <= yc && by > yc) || (by <= yc && ay > yc)) {
        const double t = (yc - ay) / (by - ay);
        xs.push_back(ax + t * (bx - ax));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      const int64_t xa = std::max<int64_t>(0, llround(std::ceil(xs[k] - 0.5)));
      const int64_t xb = std::min<int64_t>(width - 1, llround(std::floor(xs[k + 1] + 0.5)));
      int32_t* row = labels_out + y * width;
      for (int64_t x = xa; x <= xb; ++x) row[x] = val;
    }
  }
}

}  // namespace

extern "C" {

// contours: flattened (x, y) float64 pairs; offsets[i] = start index of
// contour i (in points); counts[i] = number of points of contour i.
void rasterize_labels(const double* contours, const int64_t* offsets,
                      const int64_t* counts, int64_t n_contours, int64_t height,
                      int64_t width, int32_t* labels_out) {
  std::vector<double> xs;
  for (int64_t ci = 0; ci < n_contours; ++ci) {
    fill_one(contours + offsets[ci] * 2, counts[ci], static_cast<int32_t>(ci + 1),
             height, width, labels_out, xs);
  }
}

void rasterize_labels_mt(const double* contours, const int64_t* offsets,
                         const int64_t* counts, int64_t n_contours, int64_t height,
                         int64_t width, int32_t* labels_out, int32_t num_threads) {
  if (num_threads <= 1 || n_contours < 64) {
    rasterize_labels(contours, offsets, counts, n_contours, height, width, labels_out);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<double> xs;
    for (;;) {
      const int64_t ci = next.fetch_add(1);
      if (ci >= n_contours) return;
      fill_one(contours + offsets[ci] * 2, counts[ci], static_cast<int32_t>(ci + 1),
               height, width, labels_out, xs);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t i = 0; i < num_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"

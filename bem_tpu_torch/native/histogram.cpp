// Native data-path kernels for the host-side pipeline: a copy of
// bem_tpu/native/histogram.cpp, for the port's own library.
//
// Two host-side hot spots, in a small C library bound through ctypes:
//
//  1. kde_histograms -- the per-patch Gaussian-KDE histogram condition
//     (reference: basicsr/utils/histogram.py:5-59, a triple Python loop;
//     the numpy version vectorizes but allocates a (pixels, bins)
//     temporary a patch row). Here: threaded, streaming, no temporaries.
//  2. paired_crop_augment -- fused random-crop + hflip/vflip/rot90 of an
//     LQ/GT pair (reference: basicsr/data/transforms.py:26-281) writing
//     directly into the output batch slot.
//
// Build: bem_tpu_torch/native/__init__.py compiles it at first use into
// bem_tpu_torch/build/ (g++ -O3 -shared -fPIC -pthread).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// image: (H, W, 3) float32 in [0, 1], C-contiguous.
// out:   (3, nH, nW, bins) float32. Reflect-pads partial patches like the
// reference (histogram.py:25-28).
void kde_histograms(const float* image, int H, int W, int patch, int bins,
                    float* out, int n_threads) {
  const int nH = (H + patch - 1) / patch;
  const int nW = (W + patch - 1) / patch;
  const float inv_bins = 1.0f / (bins - 1);
  const float inv_two_var = 1.0f / (2.0f * 0.01f);  // bandwidth 0.1

  auto worker = [&](int tid) {
    std::vector<float> kde(bins);
    for (int c = 0; c < 3; ++c) {
      for (int i = 0; i < nH; ++i) {
        for (int j = 0; j < nW; ++j) {
          int patch_index = (c * nH + i) * nW + j;
          if (patch_index % n_threads != tid) continue;
          std::fill(kde.begin(), kde.end(), 0.0f);
          for (int pi = 0; pi < patch; ++pi) {
            int r = i * patch + pi;
            if (r >= H) r = 2 * H - r - 2;  // reflect
            if (r < 0) r = 0;
            for (int pj = 0; pj < patch; ++pj) {
              int cidx = j * patch + pj;
              if (cidx >= W) cidx = 2 * W - cidx - 2;
              if (cidx < 0) cidx = 0;
              const float v = image[(r * W + cidx) * 3 + c];
              // exp(-(v - bin)^2 / (2 * 0.01)); bins on linspace(0,1,bins)
              for (int b = 0; b < bins; ++b) {
                const float d = v - b * inv_bins;
                kde[b] += std::exp(-d * d * inv_two_var);
              }
            }
          }
          const float inv_count = 1.0f / (patch * patch);
          float sum = 0.0f;
          for (int b = 0; b < bins; ++b) {
            kde[b] = kde[b] * inv_count + 1e-5f;
            sum += kde[b];
          }
          const float inv_sum = 1.0f / sum;
          float* dst = out + (size_t)patch_index * bins;
          for (int b = 0; b < bins; ++b) dst[b] = kde[b] * inv_sum;
        }
      }
    }
  };

  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();
  }
}

// Fused paired random crop + geometric augmentation.
// lq/gt: (H, W, 3) float32; out_lq/out_gt: (P, P, 3) float32.
// mode in [0, 8): the reference's 8 geometric variants
// (transforms.py:212-262: identity, flipud, rot90 x k, flipud(rot90 x k)).
void paired_crop_augment(const float* lq, const float* gt, int H, int W,
                         int top, int left, int P, int mode, float* out_lq,
                         float* out_gt) {
  const int k = (mode == 2 || mode == 3) ? 1 : (mode == 4 || mode == 5) ? 2
                : (mode == 6 || mode == 7) ? 3 : 0;
  const bool flipud = (mode == 1 || mode == 3 || mode == 5 || mode == 7);

  for (int y = 0; y < P; ++y) {
    for (int x = 0; x < P; ++x) {
      // inverse-map output (y, x) to crop coordinates before augmentation
      int sy = y, sx = x;
      if (flipud) sy = P - 1 - sy;
      // inverse of rot90 applied k times (numpy rot90: out[i,j] = in[j, N-1-i],
      // so out-coords (sy, sx) came from in-coords (sx, P-1-sy))
      for (int r = 0; r < k; ++r) {
        const int ty = sy;
        sy = sx;
        sx = P - 1 - ty;
      }
      const size_t src = ((size_t)(top + sy) * W + (left + sx)) * 3;
      const size_t dst = ((size_t)y * P + x) * 3;
      std::memcpy(out_lq + dst, lq + src, 3 * sizeof(float));
      std::memcpy(out_gt + dst, gt + src, 3 * sizeof(float));
    }
  }
}

}  // extern "C"

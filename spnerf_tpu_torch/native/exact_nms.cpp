// Exact greedy box-NMS over a detection heatmap.
//
// Host-side native counterpart of the sequential greedy IoU NMS the
// reference runs through torchvision (sp_utils.py:4-28): candidates are
// pixels with prob >= min_prob, each owning a size x size box centered
// on it; boxes are visited in descending score order and suppress any
// lower-scoring box whose IoU exceeds the threshold.
//
// Because two boxes of side S only overlap when |dy| < S and |dx| < S,
// suppression is resolved against kept points via a bucket grid instead
// of the O(n^2) pairwise pass: O(n * S^2 / cell) in practice.
//
// The port's copy of the JAX package's native/exact_nms.cpp, built as a
// shared library by g++ and consumed through ctypes
// (spnerf_tpu_torch/ops/native_nms.py). The static-shape NMS of
// ops/nms.py runs on the card; this one is for exact-parity evaluation
// on the host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Candidate {
  float score;
  int32_t y;
  int32_t x;
};

}  // namespace

extern "C" {

// prob: H*W row-major input heatmap.
// out:  H*W row-major output; surviving scores scattered into zeros.
// Returns the number of kept points (after top_k truncation).
int exact_nms(const float* prob, int H, int W, float box_size, float iou,
              float min_prob, int top_k, float* out) {
  std::vector<Candidate> cands;
  cands.reserve(1024);
  for (int y = 0; y < H; ++y) {
    const float* row = prob + static_cast<int64_t>(y) * W;
    for (int x = 0; x < W; ++x) {
      if (row[x] >= min_prob) cands.push_back({row[x], y, x});
    }
  }
  // descending score; stable on (y, x) to mirror torchvision's stable
  // ordering of equal scores by index
  std::stable_sort(cands.begin(), cands.end(),
                   [](const Candidate& a, const Candidate& b) {
                     return a.score > b.score;
                   });

  const float area = box_size * box_size;
  const int reach = static_cast<int>(std::ceil(box_size)) - 1;

  // bucket grid over kept points; bucket side = box_size
  const int cell = std::max(1, static_cast<int>(box_size));
  const int gw = (W + cell - 1) / cell;
  const int gh = (H + cell - 1) / cell;
  std::vector<std::vector<int>> grid(static_cast<size_t>(gw) * gh);

  std::vector<int> kept;
  kept.reserve(cands.size());

  for (int i = 0; i < static_cast<int>(cands.size()); ++i) {
    const Candidate& c = cands[i];
    bool suppressed = false;
    const int gy0 = std::max(0, (c.y - reach) / cell);
    const int gy1 = std::min(gh - 1, (c.y + reach) / cell);
    const int gx0 = std::max(0, (c.x - reach) / cell);
    const int gx1 = std::min(gw - 1, (c.x + reach) / cell);
    for (int gy = gy0; gy <= gy1 && !suppressed; ++gy) {
      for (int gx = gx0; gx <= gx1 && !suppressed; ++gx) {
        for (int k : grid[static_cast<size_t>(gy) * gw + gx]) {
          const Candidate& p = cands[static_cast<size_t>(k)];
          const float dy = std::fabs(static_cast<float>(p.y - c.y));
          const float dx = std::fabs(static_cast<float>(p.x - c.x));
          const float ih = box_size - dy;
          const float iw = box_size - dx;
          if (ih <= 0.f || iw <= 0.f) continue;
          const float inter = ih * iw;
          if (inter / (2.f * area - inter) > iou) {
            suppressed = true;
            break;
          }
        }
      }
    }
    if (!suppressed) {
      kept.push_back(i);
      grid[static_cast<size_t>(c.y / cell) * gw + c.x / cell].push_back(i);
    }
  }

  if (top_k > 0 && static_cast<int>(kept.size()) > top_k) {
    // kept is already in descending score order
    kept.resize(top_k);
  }

  std::memset(out, 0, sizeof(float) * static_cast<size_t>(H) * W);
  for (int k : kept) {
    const Candidate& c = cands[static_cast<size_t>(k)];
    out[static_cast<int64_t>(c.y) * W + c.x] = c.score;
  }
  return static_cast<int>(kept.size());
}

}  // extern "C"

// Felzenszwalb-Huttenlocher graph-based image segmentation (IJCV 2004),
// implemented from the published algorithm for the superpixel pseudo-label
// pipeline. Native replacement for the reference's third-party dependency
// (skimage.segmentation.felzenszwalb, used by
// preprocess/COCO/felzenszwalb_extraction_coco.py:31-101 with
// scale=224, sigma=0.9, min_size=224).
//
// Matches skimage's conventions so cached superpixel maps are
// interchangeable:
//   - float RGB in [0,1], per-channel gaussian pre-smoothing,
//   - 8-connected grid graph, edge weight = euclidean distance in RGB,
//   - union by increasing weight with threshold t(C) = k/|C| where k is
//     `scale` normalized like skimage (k = scale),
//   - small-component merge below min_size,
//   - labels renumbered 0..n-1 in scan order.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct Edge {
  float w;
  int32_t a, b;
};

class DisjointSet {
 public:
  explicit DisjointSet(int n) : parent_(n), rank_(n, 0), size_(n, 1) {
    for (int i = 0; i < n; ++i) parent_[i] = i;
  }
  int find(int x) {
    int root = x;
    while (parent_[root] != root) root = parent_[root];
    while (parent_[x] != root) {
      int next = parent_[x];
      parent_[x] = root;
      x = next;
    }
    return root;
  }
  void unite(int a, int b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent_[b] = a;
    size_[a] += size_[b];
    if (rank_[a] == rank_[b]) ++rank_[a];
  }
  int size(int x) { return size_[find(x)]; }

 private:
  std::vector<int32_t> parent_;
  std::vector<int8_t> rank_;
  std::vector<int32_t> size_;
};

// Separable gaussian blur, reflect boundary (matches scipy/skimage default
// truncate=4.0 kernel radius).
void GaussianBlur(const float* src, float* dst, int h, int w, double sigma) {
  if (sigma <= 0) {
    std::memcpy(dst, src, sizeof(float) * h * w);
    return;
  }
  int radius = static_cast<int>(sigma * 4.0 + 0.5);
  radius = std::max(radius, 1);
  std::vector<float> kernel(2 * radius + 1);
  double sum = 0;
  for (int i = -radius; i <= radius; ++i) {
    double v = std::exp(-0.5 * (i * i) / (sigma * sigma));
    kernel[i + radius] = static_cast<float>(v);
    sum += v;
  }
  for (auto& k : kernel) k = static_cast<float>(k / sum);

  auto reflect = [](int i, int n) {
    // scipy 'reflect' (d c b a | a b c d | d c b a)
    while (i < 0 || i >= n) {
      if (i < 0) i = -i - 1;
      if (i >= n) i = 2 * n - i - 1;
    }
    return i;
  };

  std::vector<float> tmp(static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float acc = 0;
      for (int i = -radius; i <= radius; ++i)
        acc += kernel[i + radius] * src[y * w + reflect(x + i, w)];
      tmp[y * w + x] = acc;
    }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      float acc = 0;
      for (int i = -radius; i <= radius; ++i)
        acc += kernel[i + radius] * tmp[reflect(y + i, h) * w + x];
      dst[y * w + x] = acc;
    }
}

}  // namespace

extern "C" {

// image: float32 RGB interleaved (h, w, 3) in [0, 1].
// labels_out: int32 (h, w). Returns the number of segments, or -1 on error.
int felzenszwalb_segment(const float* image, int h, int w, float scale,
                         float sigma, int min_size, int32_t* labels_out) {
  if (h <= 0 || w <= 0) return -1;
  const int n = h * w;

  // Per-channel smoothing.
  std::vector<float> smooth(static_cast<size_t>(n) * 3);
  {
    std::vector<float> chan(n), blurred(n);
    for (int c = 0; c < 3; ++c) {
      for (int i = 0; i < n; ++i) chan[i] = image[i * 3 + c];
      GaussianBlur(chan.data(), blurred.data(), h, w, sigma);
      for (int i = 0; i < n; ++i) smooth[i * 3 + c] = blurred[i];
    }
  }

  auto diff = [&](int a, int b) {
    float d0 = smooth[a * 3 + 0] - smooth[b * 3 + 0];
    float d1 = smooth[a * 3 + 1] - smooth[b * 3 + 1];
    float d2 = smooth[a * 3 + 2] - smooth[b * 3 + 2];
    return std::sqrt(d0 * d0 + d1 * d1 + d2 * d2);
  };

  // 8-connected edges.
  std::vector<Edge> edges;
  edges.reserve(static_cast<size_t>(n) * 4);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int a = y * w + x;
      if (x + 1 < w) edges.push_back({diff(a, a + 1), a, a + 1});
      if (y + 1 < h) edges.push_back({diff(a, a + w), a, a + w});
      if (x + 1 < w && y + 1 < h)
        edges.push_back({diff(a, a + w + 1), a, a + w + 1});
      if (x - 1 >= 0 && y + 1 < h)
        edges.push_back({diff(a, a + w - 1), a, a + w - 1});
    }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& l, const Edge& r) { return l.w < r.w; });

  DisjointSet ds(n);
  std::vector<float> threshold(n, scale);  // t(C) = k / |C|, |C|=1 → k
  for (const Edge& e : edges) {
    int a = ds.find(e.a), b = ds.find(e.b);
    if (a == b) continue;
    if (e.w <= threshold[a] && e.w <= threshold[b]) {
      ds.unite(a, b);
      int root = ds.find(a);
      threshold[root] = e.w + scale / ds.size(root);
    }
  }

  // Merge components smaller than min_size.
  for (const Edge& e : edges) {
    int a = ds.find(e.a), b = ds.find(e.b);
    if (a != b && (ds.size(a) < min_size || ds.size(b) < min_size))
      ds.unite(a, b);
  }

  // Renumber in scan order.
  std::vector<int32_t> remap(n, -1);
  int next = 0;
  for (int i = 0; i < n; ++i) {
    int root = ds.find(i);
    if (remap[root] < 0) remap[root] = next++;
    labels_out[i] = remap[root];
  }
  return next;
}

}  // extern "C"

// Connected-components labeling (8-connectivity) for binary masks.
//
// Host replacement for the reference's only CUDA kernel
// (reference sam2/csrc/connected_components.cu:1-289): mask postprocessing
// (hole filling / sprinkle removal) runs on small host-side mask grids, so
// a fast native host kernel serves it without a device round-trip or an
// XLA custom call.
//
// Two-pass union-find with path compression; outputs per-pixel component
// labels (1-based over foreground, 0 background) and component areas,
// matching the CUDA kernel's contract (labels + counts per pixel).
//
// Build: g++ -O3 -shared -fPIC -o libvdn_ccl.so connected_components.cc

#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(int32_t n) : parent(n) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t Find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  void Union(int32_t a, int32_t b) {
    int32_t ra = Find(a), rb = Find(b);
    if (ra == rb) return;
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
  }
};

void LabelOne(const uint8_t* mask, int32_t h, int32_t w, int32_t* labels,
              int32_t* areas) {
  const int32_t n = h * w;
  UnionFind uf(n);
  // pass 1: union with already-visited 8-neighbours (W, NW, N, NE)
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int32_t idx = y * w + x;
      if (!mask[idx]) continue;
      if (x > 0 && mask[idx - 1]) uf.Union(idx, idx - 1);
      if (y > 0) {
        const int32_t up = idx - w;
        if (mask[up]) uf.Union(idx, up);
        if (x > 0 && mask[up - 1]) uf.Union(idx, up - 1);
        if (x + 1 < w && mask[up + 1]) uf.Union(idx, up + 1);
      }
    }
  }
  // pass 2: assign compact labels + accumulate areas
  std::vector<int32_t> area_by_root(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    if (mask[i]) ++area_by_root[uf.Find(i)];
  }
  std::vector<int32_t> compact(n, 0);
  int32_t next_label = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (!mask[i]) { labels[i] = 0; areas[i] = 0; continue; }
    const int32_t root = uf.Find(i);
    if (compact[root] == 0) compact[root] = ++next_label;
    labels[i] = compact[root];
    areas[i] = area_by_root[root];
  }
}

}  // namespace

extern "C" {

// mask: [batch, h, w] uint8; labels/areas: [batch, h, w] int32 (out).
void vdn_connected_components(const uint8_t* mask, int32_t batch, int32_t h,
                              int32_t w, int32_t* labels, int32_t* areas) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int32_t b = 0; b < batch; ++b) {
    LabelOne(mask + b * plane, h, w, labels + b * plane, areas + b * plane);
  }
}

}  // extern "C"

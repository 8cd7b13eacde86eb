// Native connected-component labeling + per-source moment measurement.
//
// Native replacement for the role SExtractor (external C binary) plays
// in the reference (subpixal/catalogs.py · SExImageCatalog runs `sex` via
// subprocess — SURVEY.md §2 #6, §2a): segmentation of a thresholded
// detection image into labeled sources. Labeling is an irregular,
// pointer-chasing union-find — a poor fit for an accelerator's vector units — so
// it runs on host in C++ (this file), while all per-source *measurement*
// (centroids, fluxes, windowed moments over cutouts) is vectorized on
// device in JAX. Loaded via ctypes (no pybind11 in this image); a
// scipy.ndimage fallback exists in Python.
//
// API (C, stable):
//   label_components(mask, H, W, connectivity, labels_out) -> n_labels
//     mask: uint8 H*W (nonzero = above threshold)
//     labels_out: int32 H*W, 0 = background, 1..n = components
//   component_stats(labels, data, H, W, n, area, flux, cx, cy,
//                   xmin, xmax, ymin, ymax, peak)
//     first-order moments + bbox + peak per label (arrays length n+1,
//     entry 0 unused).

#include <cstdint>
#include <vector>

extern "C" {

static inline int32_t uf_find(std::vector<int32_t>& parent, int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {  // path compression
        int32_t next = parent[x];
        parent[x] = root;
        x = next;
    }
    return root;
}

static inline void uf_union(std::vector<int32_t>& parent, int32_t a, int32_t b) {
    int32_t ra = uf_find(parent, a), rb = uf_find(parent, b);
    if (ra != rb) parent[ra > rb ? ra : rb] = (ra > rb ? rb : ra);
}

// Two-pass union-find labeling. connectivity: 4 or 8.
int32_t label_components(const uint8_t* mask, int64_t H, int64_t W,
                         int connectivity, int32_t* labels) {
    std::vector<int32_t> parent;
    parent.reserve(1024);
    parent.push_back(0);  // background sentinel

    for (int64_t y = 0; y < H; ++y) {
        for (int64_t x = 0; x < W; ++x) {
            const int64_t i = y * W + x;
            if (!mask[i]) { labels[i] = 0; continue; }
            // neighbors already visited in raster order
            int32_t neigh[4];
            int nn = 0;
            if (x > 0 && labels[i - 1]) neigh[nn++] = labels[i - 1];
            if (y > 0) {
                if (labels[i - W]) neigh[nn++] = labels[i - W];
                if (connectivity == 8) {
                    if (x > 0 && labels[i - W - 1]) neigh[nn++] = labels[i - W - 1];
                    if (x + 1 < W && labels[i - W + 1]) neigh[nn++] = labels[i - W + 1];
                }
            }
            if (nn == 0) {
                int32_t lab = (int32_t)parent.size();
                parent.push_back(lab);
                labels[i] = lab;
            } else {
                int32_t m = neigh[0];
                for (int k = 1; k < nn; ++k) if (neigh[k] < m) m = neigh[k];
                labels[i] = m;
                for (int k = 0; k < nn; ++k) uf_union(parent, m, neigh[k]);
            }
        }
    }
    // flatten + renumber 1..n
    std::vector<int32_t> remap(parent.size(), 0);
    int32_t n = 0;
    for (int32_t l = 1; l < (int32_t)parent.size(); ++l) {
        int32_t r = uf_find(parent, l);
        if (r == l) remap[l] = ++n;
    }
    for (int32_t l = 1; l < (int32_t)parent.size(); ++l)
        remap[l] = remap[uf_find(parent, l)];
    for (int64_t i = 0; i < H * W; ++i)
        labels[i] = remap[labels[i]];
    return n;
}

// First-order moments, bbox and peak per component.
void component_stats(const int32_t* labels, const float* data,
                     int64_t H, int64_t W, int32_t n,
                     int64_t* area, double* flux, double* cx, double* cy,
                     int32_t* xmin, int32_t* xmax, int32_t* ymin,
                     int32_t* ymax, float* peak) {
    for (int32_t l = 0; l <= n; ++l) {
        area[l] = 0; flux[l] = 0.0; cx[l] = 0.0; cy[l] = 0.0;
        xmin[l] = (int32_t)W; xmax[l] = -1; ymin[l] = (int32_t)H; ymax[l] = -1;
        peak[l] = -3.4e38f;
    }
    for (int64_t y = 0; y < H; ++y) {
        for (int64_t x = 0; x < W; ++x) {
            const int32_t l = labels[y * W + x];
            if (!l) continue;
            const float v = data[y * W + x];
            area[l] += 1;
            flux[l] += v;
            cx[l] += v * (double)x;
            cy[l] += v * (double)y;
            if ((int32_t)x < xmin[l]) xmin[l] = (int32_t)x;
            if ((int32_t)x > xmax[l]) xmax[l] = (int32_t)x;
            if ((int32_t)y < ymin[l]) ymin[l] = (int32_t)y;
            if ((int32_t)y > ymax[l]) ymax[l] = (int32_t)y;
            if (v > peak[l]) peak[l] = v;
        }
    }
    for (int32_t l = 1; l <= n; ++l) {
        if (flux[l] != 0.0) { cx[l] /= flux[l]; cy[l] /= flux[l]; }
        else if (area[l] > 0) {  // zero-flux blob: unweighted centroid
            double sx = 0, sy = 0; int64_t cnt = 0;
            // cheap fallback: bbox center
            cx[l] = 0.5 * (xmin[l] + xmax[l]);
            cy[l] = 0.5 * (ymin[l] + ymax[l]);
            (void)sx; (void)sy; (void)cnt;
        }
    }
}

}  // extern "C"

// Exact Meyer priority-flood watershed with watershed lines — native host kernel.
//
// The card's path (ops/watershed.py, csrc/flood.cu) re-derives the flood as a
// data-parallel program; this C++ kernel keeps the exact sequential heap
// semantics of skimage.segmentation.watershed(image, watershed_line=True) for
// (a) large-scale parity validation of the card's flood and (b) a host oracle —
// the reference's own hot loop lived inside skimage's compiled flood
// (reference basic_image_manipulations.py:475). A copy of the JAX package's
// native/watershed.cpp.
//
// Build: g++ -O3 -shared -fPIC watershed.cpp -o libtipws.so   (see build.py)

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Entry {
    float value;
    uint64_t order;
    int32_t index;
};

struct Cmp {
    bool operator()(const Entry& a, const Entry& b) const {
        if (a.value != b.value) return a.value > b.value;  // min-heap by value
        return a.order > b.order;                          // FIFO tie-break
    }
};

}  // namespace

extern "C" {

// Label regional minima (8-connected plateaus with no lower neighbor), 4-connected
// components in raster order. Returns the number of minima.
int32_t regional_minima(const float* img, int32_t H, int32_t W, int32_t* out) {
    const int64_t n = static_cast<int64_t>(H) * W;
    std::vector<uint8_t> candidate(n, 0);
    auto at = [&](int64_t y, int64_t x) { return img[y * W + x]; };
    for (int64_t y = 0; y < H; ++y) {
        for (int64_t x = 0; x < W; ++x) {
            float v = at(y, x);
            bool cand = true;
            for (int dy = -1; dy <= 1 && cand; ++dy) {
                for (int dx = -1; dx <= 1; ++dx) {
                    if (!dy && !dx) continue;
                    int64_t qy = y + dy, qx = x + dx;
                    if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
                    if (at(qy, qx) < v) { cand = false; break; }
                }
            }
            candidate[y * W + x] = cand;
        }
    }
    // drop escaping plateaus: BFS equal-valued from non-candidate neighbors
    std::vector<int64_t> stack;
    for (int64_t y = 0; y < H; ++y) {
        for (int64_t x = 0; x < W; ++x) {
            if (candidate[y * W + x]) continue;
            float v = at(y, x);
            for (int dy = -1; dy <= 1; ++dy) {
                for (int dx = -1; dx <= 1; ++dx) {
                    if (!dy && !dx) continue;
                    int64_t qy = y + dy, qx = x + dx;
                    if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
                    int64_t qi = qy * W + qx;
                    if (candidate[qi] && img[qi] == v) stack.push_back(qi);
                }
            }
        }
    }
    while (!stack.empty()) {
        int64_t i = stack.back();
        stack.pop_back();
        if (!candidate[i]) continue;
        candidate[i] = 0;
        int64_t y = i / W, x = i % W;
        float v = img[i];
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dx = -1; dx <= 1; ++dx) {
                if (!dy && !dx) continue;
                int64_t qy = y + dy, qx = x + dx;
                if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
                int64_t qi = qy * W + qx;
                if (candidate[qi] && img[qi] == v) stack.push_back(qi);
            }
        }
    }
    // 4-connected components in raster order
    std::memset(out, 0, n * sizeof(int32_t));
    int32_t next = 0;
    std::vector<int64_t> bfs;
    for (int64_t i = 0; i < n; ++i) {
        if (!candidate[i] || out[i]) continue;
        ++next;
        bfs.assign(1, i);
        out[i] = next;
        while (!bfs.empty()) {
            int64_t j = bfs.back();
            bfs.pop_back();
            int64_t y = j / W, x = j % W;
            const int64_t qys[4] = {y - 1, y + 1, y, y};
            const int64_t qxs[4] = {x, x, x - 1, x + 1};
            for (int k = 0; k < 4; ++k) {
                int64_t qy = qys[k], qx = qxs[k];
                if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
                int64_t qi = qy * W + qx;
                if (candidate[qi] && !out[qi]) {
                    out[qi] = next;
                    bfs.push_back(qi);
                }
            }
        }
    }
    return next;
}

// Meyer flood from markers (int32, 0 = unlabeled), 4-connectivity, watershed lines.
// out must be initialized with the markers; line pixels end up 0.
void meyer_watershed(const float* img, int32_t H, int32_t W, int32_t* out,
                     int32_t watershed_line) {
    const int64_t n = static_cast<int64_t>(H) * W;
    std::priority_queue<Entry, std::vector<Entry>, Cmp> heap;
    std::vector<uint8_t> visited(n, 0);
    uint64_t order = 0;
    const int32_t WSL = -1;
    auto push_neighbors = [&](int64_t i) {
        int64_t y = i / W, x = i % W;
        const int64_t qys[4] = {y - 1, y + 1, y, y};
        const int64_t qxs[4] = {x, x, x - 1, x + 1};
        for (int k = 0; k < 4; ++k) {
            int64_t qy = qys[k], qx = qxs[k];
            if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
            int64_t qi = qy * W + qx;
            if (!visited[qi]) {
                visited[qi] = 1;
                heap.push({img[qi], order++, static_cast<int32_t>(qi)});
            }
        }
    };
    for (int64_t i = 0; i < n; ++i) {
        if (out[i] > 0) visited[i] = 1;
    }
    for (int64_t i = 0; i < n; ++i) {
        if (out[i] > 0) push_neighbors(i);
    }
    while (!heap.empty()) {
        Entry e = heap.top();
        heap.pop();
        int64_t i = e.index;
        int64_t y = i / W, x = i % W;
        int32_t label = 0;
        bool conflict = false;
        const int64_t qys[4] = {y - 1, y + 1, y, y};
        const int64_t qxs[4] = {x, x, x - 1, x + 1};
        for (int k = 0; k < 4; ++k) {
            int64_t qy = qys[k], qx = qxs[k];
            if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
            int32_t ql = out[qy * W + qx];
            if (ql > 0) {
                if (label == 0) label = ql;
                else if (label != ql) conflict = true;
            }
        }
        if (conflict && watershed_line) {
            out[i] = WSL;
        } else {
            out[i] = label;
            push_neighbors(i);
        }
    }
    if (watershed_line) {
        for (int64_t i = 0; i < n; ++i) {
            if (out[i] == WSL) out[i] = 0;
        }
    }
}

// Full pipeline: minima + flood.
int32_t watershed(const float* img, int32_t H, int32_t W, int32_t* out,
                  int32_t watershed_line) {
    int32_t nmin = regional_minima(img, H, W, out);
    meyer_watershed(img, H, W, out, watershed_line);
    return nmin;
}

}  // extern "C"

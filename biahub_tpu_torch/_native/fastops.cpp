// Host-side helpers of biahub_tpu_torch, compiled on first use and loaded
// with ctypes (biahub_tpu_torch/_native/__init__.py); a copy of the
// reference's biahub_tpu/_native/fastops.cpp.
//
// The card owns the voxel work; these are the host-side combinatorial loops
// that would otherwise run as Python-level iteration:
//   - lir_2d: largest all-true rectangle of a binary mask (histogram-stack
//     algorithm, O(H*W)); the register verb's overlap crop (register.py
//     find_lir) on multi-megapixel masks.
//   - edge_consistency_costs: the graph-matching cost matrix's per-(i, j)
//     sorted-assignment DP (transforms/graph_matching.py), O(N*M*k^2).

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// Largest all-true rectangle of mask (h x w, row-major uint8).
// Writes [x, y, width, height] into out4.
void lir_2d(const uint8_t* mask, int64_t h, int64_t w, int64_t* out4) {
    std::vector<int64_t> heights(w, 0);
    std::vector<int64_t> stack;
    stack.reserve(w + 1);
    int64_t best_area = 0;
    out4[0] = out4[1] = out4[2] = out4[3] = 0;

    for (int64_t row = 0; row < h; ++row) {
        const uint8_t* mrow = mask + row * w;
        for (int64_t c = 0; c < w; ++c) {
            heights[c] = mrow[c] ? heights[c] + 1 : 0;
        }
        stack.clear();
        int64_t col = 0;
        while (col <= w) {
            int64_t cur = (col < w) ? heights[col] : 0;
            if (stack.empty() || cur >= heights[stack.back()]) {
                stack.push_back(col);
                ++col;
            } else {
                int64_t top = stack.back();
                stack.pop_back();
                int64_t width = stack.empty() ? col : col - stack.back() - 1;
                int64_t area = heights[top] * width;
                if (area > best_area) {
                    best_area = area;
                    int64_t left = stack.empty() ? 0 : stack.back() + 1;
                    out4[0] = left;                       // x
                    out4[1] = row - heights[top] + 1;     // y
                    out4[2] = width;                      // width
                    out4[3] = heights[top];               // height
                }
            }
        }
    }
}

// Mean optimal-assignment cost between two sorted scalar sequences
// (monotone-alignment DP; equivalent to the rectangular Hungarian solve on
// |a_i - b_j| since sorted scalar assignments are monotone).
static double sorted_assignment_cost(const double* a, int64_t ka,
                                     const double* b, int64_t kb,
                                     double* dp_prev, double* dp_cur) {
    const double* small = a;
    const double* big = b;
    int64_t ks = ka, kbg = kb;
    if (ka > kb) { small = b; big = a; ks = kb; kbg = ka; }

    for (int64_t j = 0; j <= kbg; ++j) dp_prev[j] = 0.0;
    const double INF = 1e300;
    for (int64_t i = 1; i <= ks; ++i) {
        for (int64_t j = 0; j < i; ++j) dp_cur[j] = INF;
        for (int64_t j = i; j <= kbg; ++j) {
            double match = dp_prev[j - 1] + std::fabs(small[i - 1] - big[j - 1]);
            double skip = dp_cur[j - 1];
            dp_cur[j] = match < skip ? match : skip;
        }
        std::swap(dp_prev, dp_cur);
    }
    return dp_prev[kbg] / static_cast<double>(ks);
}

// Cost matrix (n x m, row-major) of sorted-assignment costs between each
// moving node's sorted edge attributes and each reference node's.
// mov_attrs / ref_attrs are flattened ragged arrays with offsets.
void edge_consistency_costs(
    const double* mov_attrs, const int64_t* mov_offsets, int64_t n,
    const double* ref_attrs, const int64_t* ref_offsets, int64_t m,
    double default_cost, double* out /* n*m */) {
    int64_t max_k = 1;
    for (int64_t i = 0; i < n; ++i)
        max_k = std::max(max_k, mov_offsets[i + 1] - mov_offsets[i]);
    for (int64_t j = 0; j < m; ++j)
        max_k = std::max(max_k, ref_offsets[j + 1] - ref_offsets[j]);
    std::vector<double> dp_prev(max_k + 1), dp_cur(max_k + 1);

    for (int64_t i = 0; i < n; ++i) {
        int64_t ka = mov_offsets[i + 1] - mov_offsets[i];
        const double* a = mov_attrs + mov_offsets[i];
        for (int64_t j = 0; j < m; ++j) {
            int64_t kb = ref_offsets[j + 1] - ref_offsets[j];
            if (ka == 0 || kb == 0) {
                out[i * m + j] = default_cost;
                continue;
            }
            out[i * m + j] = sorted_assignment_cost(
                a, ka, ref_attrs + ref_offsets[j], kb,
                dp_prev.data(), dp_cur.data());
        }
    }
}

}  // extern "C"

// Berger-Rigoutsos tag clustering with anisotropic (per-direction)
// refinement support.
//
// Native re-design of the reference's LepticMeshRefine
// (the reference's src/MappedChombo/LepticMeshRefine.H:16 - Berger-
// Rigoutsos clustering generalized to IntVect ratios, spanDirs forcing,
// proper nesting with anisotropic buffers).  The reference runs this in
// C++ on the host at every regrid; so do we - regridding is inherently
// host-side (it changes array shapes/offsets), so the hot clustering
// loops live here, called from Python via ctypes.
//
// Algorithm (Berger & Rigoutsos, IEEE Trans. Systems Man Cybernet. 1991):
// recursively split the tag bounding box at signature-histogram holes or
// max-Laplacian inflection points until every box is efficient
// (tagged/total >= fill_ratio) or minimal.
//
// Exports a C ABI:
//   br_cluster(tags, n0, n1, n2, fill_ratio, max_boxes, min_side,
//              out_boxes /* [max_boxes][6] lo0 lo1 lo2 hi0 hi1 hi2 */)
//   -> number of boxes written.
// 2D inputs pass n2 == 1.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Box {
    int lo[3];
    int hi[3];  // inclusive

    int size(int d) const { return hi[d] - lo[d] + 1; }
    long volume() const {
        return (long)size(0) * (long)size(1) * (long)size(2);
    }
};

struct TagField {
    const uint8_t* data;
    int n[3];

    bool tagged(int i0, int i1, int i2) const {
        return data[(i0 * (long)n[1] + i1) * n[2] + i2] != 0;
    }
};

// Count tags and shrink the box to the tag bounding box.  Returns count.
long shrink_to_tags(const TagField& t, Box& b) {
    int lo[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int hi[3] = {-1, -1, -1};
    long count = 0;
    for (int i = b.lo[0]; i <= b.hi[0]; ++i)
        for (int j = b.lo[1]; j <= b.hi[1]; ++j)
            for (int k = b.lo[2]; k <= b.hi[2]; ++k)
                if (t.tagged(i, j, k)) {
                    ++count;
                    lo[0] = std::min(lo[0], i); hi[0] = std::max(hi[0], i);
                    lo[1] = std::min(lo[1], j); hi[1] = std::max(hi[1], j);
                    lo[2] = std::min(lo[2], k); hi[2] = std::max(hi[2], k);
                }
    if (count) {
        std::memcpy(b.lo, lo, sizeof lo);
        std::memcpy(b.hi, hi, sizeof hi);
    }
    return count;
}

// Signature (tag histogram) along direction d.
void signature(const TagField& t, const Box& b, int d, std::vector<long>& sig) {
    sig.assign(b.size(d), 0);
    for (int i = b.lo[0]; i <= b.hi[0]; ++i)
        for (int j = b.lo[1]; j <= b.hi[1]; ++j)
            for (int k = b.lo[2]; k <= b.hi[2]; ++k)
                if (t.tagged(i, j, k)) {
                    int idx[3] = {i, j, k};
                    ++sig[idx[d] - b.lo[d]];
                }
}

// Find the best split plane: prefer a hole in a signature; otherwise the
// strongest zero-crossing of the signature Laplacian; otherwise midpoint
// of the longest side.  Returns (dir, index-after-which-to-split) or
// dir = -1 when the box should not be split.
void find_split(const TagField& t, const Box& b, int min_side,
                int& sdir, int& spos) {
    sdir = -1;
    spos = 0;
    std::vector<long> sig;

    // 1. holes
    long best_dist = -1;
    for (int d = 0; d < 3; ++d) {
        if (b.size(d) < 2 * min_side) continue;
        signature(t, b, d, sig);
        const int nd = (int)sig.size();
        for (int i = min_side - 1; i < nd - min_side; ++i) {
            if (sig[i] == 0) {
                long dist = std::min<long>(i, nd - 1 - i);  // centered best
                if (dist > best_dist) {
                    best_dist = dist;
                    sdir = d;
                    spos = i;
                }
            }
        }
    }
    if (sdir >= 0) return;

    // 2. Laplacian inflection
    long best_mag = -1;
    for (int d = 0; d < 3; ++d) {
        if (b.size(d) < 2 * min_side) continue;
        signature(t, b, d, sig);
        const int nd = (int)sig.size();
        std::vector<long> lap(nd, 0);
        for (int i = 1; i < nd - 1; ++i)
            lap[i] = sig[i + 1] - 2 * sig[i] + sig[i - 1];
        for (int i = std::max(1, min_side - 1);
             i < std::min(nd - 2, nd - min_side); ++i) {
            if ((lap[i] > 0) != (lap[i + 1] > 0) || lap[i] == 0) {
                long mag = std::abs(lap[i] - lap[i + 1]);
                if (mag > best_mag) {
                    best_mag = mag;
                    sdir = d;
                    spos = i;
                }
            }
        }
    }
    if (sdir >= 0 && best_mag > 0) return;

    // 3. midpoint of longest splittable side
    int longest = -1, len = 0;
    for (int d = 0; d < 3; ++d) {
        if (b.size(d) >= 2 * min_side && b.size(d) > len) {
            len = b.size(d);
            longest = d;
        }
    }
    if (longest >= 0) {
        sdir = longest;
        spos = b.size(longest) / 2 - 1;
    }
}

void cluster(const TagField& t, Box b, double fill_ratio, int min_side,
             int max_boxes, std::vector<Box>& out) {
    long count = shrink_to_tags(t, b);
    if (count == 0) return;
    double eff = (double)count / (double)b.volume();
    if (eff >= fill_ratio || (int)out.size() + 1 >= max_boxes) {
        out.push_back(b);
        return;
    }
    int sdir, spos;
    find_split(t, b, min_side, sdir, spos);
    if (sdir < 0) {
        out.push_back(b);
        return;
    }
    Box left = b, right = b;
    left.hi[sdir] = b.lo[sdir] + spos;
    right.lo[sdir] = b.lo[sdir] + spos + 1;
    cluster(t, left, fill_ratio, min_side, max_boxes, out);
    cluster(t, right, fill_ratio, min_side, max_boxes, out);
}

}  // namespace

extern "C" {

int br_cluster(const uint8_t* tags, int n0, int n1, int n2,
               double fill_ratio, int max_boxes, int min_side,
               int* out_boxes) {
    TagField t{tags, {n0, n1, n2}};
    Box whole{{0, 0, 0}, {n0 - 1, n1 - 1, n2 - 1}};
    std::vector<Box> boxes;
    cluster(t, whole, fill_ratio, min_side, max_boxes, boxes);
    int n = std::min<int>((int)boxes.size(), max_boxes);
    for (int i = 0; i < n; ++i) {
        out_boxes[6 * i + 0] = boxes[i].lo[0];
        out_boxes[6 * i + 1] = boxes[i].lo[1];
        out_boxes[6 * i + 2] = boxes[i].lo[2];
        out_boxes[6 * i + 3] = boxes[i].hi[0];
        out_boxes[6 * i + 4] = boxes[i].hi[1];
        out_boxes[6 * i + 5] = boxes[i].hi[2];
    }
    return n;
}

// Bounding box of all tags: fast path used by the single-patch AMR level
// (returns 0 if no tags, else 1 and fills out_box[6]).
int tag_bounding_box(const uint8_t* tags, int n0, int n1, int n2,
                     int* out_box) {
    TagField t{tags, {n0, n1, n2}};
    Box b{{0, 0, 0}, {n0 - 1, n1 - 1, n2 - 1}};
    long count = shrink_to_tags(t, b);
    if (!count) return 0;
    out_box[0] = b.lo[0]; out_box[1] = b.lo[1]; out_box[2] = b.lo[2];
    out_box[3] = b.hi[0]; out_box[4] = b.hi[1]; out_box[5] = b.hi[2];
    return 1;
}

}  // extern "C"

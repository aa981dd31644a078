// 3D connected-component labeling (6-connectivity) via union-find.
//
// The PyTorch port's copy of the repo's native/cc3d.cpp (same extern "C"
// symbols, same bodies), so the port builds nothing outside its package:
// the host tier of the serving cascade, two-pass with path-compressed
// union-find, built with g++ at first use and loaded through ctypes by
// runet_tpu_torch/utils/native.py.
//
// Row-major C-contiguous input: index(x, y, z) = (x*ny + y)*nz + z.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;

  int32_t make() {
    parent.push_back(static_cast<int32_t>(parent.size()));
    return parent.back();
  }

  int32_t find(int32_t a) {
    int32_t root = a;
    while (parent[root] != root) root = parent[root];
    while (parent[a] != root) {
      int32_t next = parent[a];
      parent[a] = root;
      a = next;
    }
    return root;
  }

  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (b < a) {
      int32_t t = a;
      a = b;
      b = t;
    }
    parent[b] = a;  // smaller root wins
  }
};

}  // namespace

// Zero out every voxel of `seg` whose foreground component (per `labels`,
// 1..n_labels from label_components_3d) is not among the `keep_k` largest
// with more than `min_voxels` voxels. One pass over sizes + one over voxels.
extern "C" void keep_largest_components_3d(uint8_t* seg, const int32_t* labels,
                                           int64_t n, int32_t n_labels,
                                           int32_t keep_k, int64_t min_voxels) {
  if (n_labels <= 0) return;
  std::vector<int64_t> sizes(static_cast<std::size_t>(n_labels) + 1, 0);
  for (int64_t i = 0; i < n; ++i) sizes[labels[i]]++;
  sizes[0] = 0;

  // Component ids sorted by size descending. Speckly predictions can have
  // thousands of components, so partial-sort the top keep_k instead of a
  // quadratic full sort.
  std::vector<int32_t> order;
  order.reserve(n_labels);
  for (int32_t c = 1; c <= n_labels; ++c) order.push_back(c);
  const std::size_t k =
      std::min<std::size_t>(order.size(), static_cast<std::size_t>(keep_k));
  std::partial_sort(order.begin(), order.begin() + k, order.end(),
                    [&sizes](int32_t a, int32_t b) { return sizes[a] > sizes[b]; });

  std::vector<uint8_t> keep(static_cast<std::size_t>(n_labels) + 1, 0);
  for (int32_t k = 0; k < keep_k && k < n_labels; ++k) {
    if (sizes[order[k]] > min_voxels) keep[order[k]] = 1;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] > 0 && !keep[labels[i]]) seg[i] = 0;
  }
}

extern "C" int32_t label_components_3d(const uint8_t* mask, int32_t* out,
                                       int64_t nx, int64_t ny, int64_t nz) {
  const int64_t n = nx * ny * nz;
  if (n <= 0) return 0;

  // Run-based two-pass CCL: foreground z-runs per (x,y) line, each run one
  // union-find node, united with interval-overlapping runs in the -y and -x
  // neighbor lines (6-connectivity => plain interval intersection). Dense
  // anatomy (few long runs) does orders of magnitude fewer UF operations
  // than the per-voxel formulation; the output pass is memset + run fills.
  struct Run {
    int32_t z0, z1, label;  // [z0, z1), provisional UF label
  };
  const int64_t n_lines = nx * ny;
  std::vector<Run> runs;
  runs.reserve(1024);
  // Per-line [start, end) offsets into `runs`.
  std::vector<int64_t> line_off(static_cast<std::size_t>(n_lines) + 1, 0);
  UnionFind uf;
  uf.parent.reserve(1024);

  for (int64_t x = 0; x < nx; ++x) {
    for (int64_t y = 0; y < ny; ++y) {
      const int64_t line = x * ny + y;
      const uint8_t* row = mask + line * nz;
      const std::size_t first = runs.size();
      int64_t z = 0;
      while (z < nz) {
        if (!row[z]) {
          ++z;
          continue;
        }
        const int64_t z0 = z;
        while (z < nz && row[z]) ++z;
        runs.push_back({static_cast<int32_t>(z0), static_cast<int32_t>(z),
                        uf.make()});
      }
      line_off[line + 1] = static_cast<int64_t>(runs.size());

      // Unite with overlapping runs of the two already-visited neighbor
      // lines (two-pointer sweep; both run lists are z-sorted).
      const int64_t nbrs[2] = {y > 0 ? line - 1 : -1, x > 0 ? line - ny : -1};
      for (int64_t nbr : nbrs) {
        if (nbr < 0) continue;
        std::size_t a = first, b = static_cast<std::size_t>(line_off[nbr]);
        const std::size_t a_end = runs.size();
        const std::size_t b_end = static_cast<std::size_t>(line_off[nbr + 1]);
        while (a < a_end && b < b_end) {
          const Run& ra = runs[a];
          const Run& rb = runs[b];
          if (ra.z0 < rb.z1 && rb.z0 < ra.z1) uf.unite(ra.label, rb.label);
          // Advance whichever interval ends first.
          if (ra.z1 < rb.z1) ++a;
          else ++b;
        }
      }
    }
  }

  // Compress roots to dense 1..K labels.
  std::vector<int32_t> dense(uf.parent.size(), 0);
  int32_t next_label = 0;
  for (std::size_t p = 0; p < uf.parent.size(); ++p) {
    if (uf.find(static_cast<int32_t>(p)) == static_cast<int32_t>(p)) {
      dense[p] = ++next_label;
    }
  }

  // Output pass: zero background, fill runs with their dense root label.
  std::fill(out, out + n, 0);
  for (int64_t line = 0; line < n_lines; ++line) {
    int32_t* orow = out + line * nz;
    for (int64_t r = line_off[line]; r < line_off[line + 1]; ++r) {
      const Run& run = runs[static_cast<std::size_t>(r)];
      const int32_t lab = dense[uf.find(run.label)];
      std::fill(orow + run.z0, orow + run.z1, lab);
    }
  }
  return next_label;
}

// Zero `seg[i]` wherever its component is not marked in `keep` (a LUT of
// n_labels+1 bytes indexed by label id; keep[0] is ignored — background is
// never touched). Lets the caller rank components globally across several
// independently-labeled crops and kill in one native pass per crop, instead
// of a numpy isin (sort-based) per crop.
extern "C" void zero_nonkept_3d(uint8_t* seg, const int32_t* labels, int64_t n,
                                const uint8_t* keep) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t l = labels[i];
    if (l > 0 && !keep[l]) seg[i] = 0;
  }
}

// Fused box-scoped keep-largest: in place on a uint8 label canvas, for each
// (pairwise-disjoint) box run run-based 6-connected CC over nonzero voxels,
// rank component sizes GLOBALLY across boxes, and zero every voxel whose
// component is not among the `keep_k` largest with more than `min_voxels`
// voxels. One read pass over box voxels + writes only to killed runs —
// no int32 label volume, no crop copies (the Python chain this replaces did
// ~7 extra full-crop passes). Boxes: int64[n_boxes*6] (x0,y0,z0,x1,y1,z1
// exclusive), clamped by the caller to the canvas. Returns the total
// component count across boxes.
extern "C" int64_t keep_largest_in_boxes_3d(uint8_t* seg, int64_t nx,
                                            int64_t ny, int64_t nz,
                                            const int64_t* boxes,
                                            int32_t n_boxes, int32_t keep_k,
                                            int64_t min_voxels) {
  (void)nx;
  struct Run {
    int64_t base;       // seg offset of the (x,y) line: (x*ny + y)*nz
    int32_t z0, z1;     // [z0, z1)
    int32_t label;      // provisional per-box UF id, then GLOBAL dense id
  };
  std::vector<Run> runs;
  runs.reserve(1024);
  std::vector<int64_t> sizes;  // global dense component sizes, 0-indexed
  UnionFind uf;

  for (int32_t bi = 0; bi < n_boxes; ++bi) {
    const int64_t* b = boxes + static_cast<int64_t>(bi) * 6;
    const int64_t x0 = b[0], y0 = b[1], z0 = b[2];
    const int64_t x1 = b[3], y1 = b[4], z1 = b[5];
    const int64_t bny = y1 - y0;
    if (x1 <= x0 || bny <= 0 || z1 <= z0) continue;
    const std::size_t box_run_first = runs.size();
    uf.parent.clear();
    // Per box-local line [start, end) offsets into `runs`.
    std::vector<std::size_t> line_off(
        static_cast<std::size_t>((x1 - x0) * bny) + 1, box_run_first);
    for (int64_t x = x0; x < x1; ++x) {
      for (int64_t y = y0; y < y1; ++y) {
        const int64_t base = (x * ny + y) * nz;
        const uint8_t* row = seg + base;
        const std::size_t lline = static_cast<std::size_t>(
            (x - x0) * bny + (y - y0));
        const std::size_t first = runs.size();
        int64_t z = z0;
        while (z < z1) {
          if (!row[z]) {
            ++z;
            continue;
          }
          const int64_t rz0 = z;
          while (z < z1 && row[z]) ++z;
          runs.push_back({base, static_cast<int32_t>(rz0),
                          static_cast<int32_t>(z), uf.make()});
        }
        line_off[lline + 1] = runs.size();
        const std::ptrdiff_t nbrs[2] = {
            y > y0 ? static_cast<std::ptrdiff_t>(lline) - 1 : -1,
            x > x0 ? static_cast<std::ptrdiff_t>(lline) -
                         static_cast<std::ptrdiff_t>(bny)
                   : -1};
        for (std::ptrdiff_t nbr : nbrs) {
          if (nbr < 0) continue;
          std::size_t a = first, c = line_off[static_cast<std::size_t>(nbr)];
          const std::size_t a_end = runs.size();
          const std::size_t c_end =
              line_off[static_cast<std::size_t>(nbr) + 1];
          while (a < a_end && c < c_end) {
            const Run& ra = runs[a];
            const Run& rc = runs[c];
            if (ra.z0 < rc.z1 && rc.z0 < ra.z1) uf.unite(ra.label, rc.label);
            if (ra.z1 < rc.z1) ++a;
            else ++c;
          }
        }
      }
    }
    // Compress this box's roots to GLOBAL dense ids; accumulate sizes from
    // run lengths (no voxel pass) and relabel runs in place.
    const int32_t global_base = static_cast<int32_t>(sizes.size());
    std::vector<int32_t> dense(uf.parent.size(), -1);
    for (std::size_t p = 0; p < uf.parent.size(); ++p) {
      if (uf.find(static_cast<int32_t>(p)) == static_cast<int32_t>(p)) {
        dense[p] = static_cast<int32_t>(sizes.size());
        sizes.push_back(0);
      }
    }
    for (std::size_t r = box_run_first; r < runs.size(); ++r) {
      Run& run = runs[r];
      run.label = dense[uf.find(run.label)];
      sizes[run.label] += run.z1 - run.z0;
    }
    (void)global_base;
  }

  const int64_t n_total = static_cast<int64_t>(sizes.size());
  if (n_total == 0) return 0;
  std::vector<int32_t> order(sizes.size());
  for (std::size_t c = 0; c < order.size(); ++c)
    order[c] = static_cast<int32_t>(c);
  const std::size_t k = std::min<std::size_t>(
      order.size(), static_cast<std::size_t>(keep_k > 0 ? keep_k : 0));
  std::partial_sort(
      order.begin(), order.begin() + k, order.end(),
      [&sizes](int32_t a, int32_t b) { return sizes[a] > sizes[b]; });
  std::vector<uint8_t> keep(sizes.size(), 0);
  for (std::size_t i = 0; i < k; ++i) {
    if (sizes[order[i]] > min_voxels) keep[order[i]] = 1;
  }
  for (const Run& run : runs) {
    if (!keep[run.label]) {
      std::fill(seg + run.base + run.z0, seg + run.base + run.z1,
                static_cast<uint8_t>(0));
    }
  }
  return n_total;
}

// Fused nibble-unpack + nonzero paste (cascade ROI write-back). `packed` is
// a C-contiguous uint8 (sx, sy, szp) nibble volume — two z voxels per byte,
// LOW nibble = even z (infer/packing.py pack_nibbles) — of which the
// (ex, ey, ez) prefix is pasted into the canvas at (lo0, lo1, lo2): nonzero
// nibbles overwrite, zero nibbles keep the destination (np.where semantics
// on overlapping ROI boxes). Replaces unpack_nibbles + slice + np.where —
// ~4 full-crop numpy passes — with one read of the packed bytes.
extern "C" void paste_nibbles_3d(uint8_t* canvas, int64_t ny, int64_t nz,
                                 const uint8_t* packed, int64_t sy,
                                 int64_t szp, int64_t lo0, int64_t lo1,
                                 int64_t lo2, int64_t ex, int64_t ey,
                                 int64_t ez) {
  const int64_t pairs = ez / 2;
  for (int64_t x = 0; x < ex; ++x) {
    for (int64_t y = 0; y < ey; ++y) {
      uint8_t* row = canvas + ((lo0 + x) * ny + (lo1 + y)) * nz + lo2;
      const uint8_t* prow = packed + (x * sy + y) * szp;
      for (int64_t i = 0; i < pairs; ++i) {
        const uint8_t b = prow[i];
        const uint8_t lo_n = b & 0x0F;
        const uint8_t hi_n = b >> 4;
        if (lo_n) row[2 * i] = lo_n;
        if (hi_n) row[2 * i + 1] = hi_n;
      }
      if (ez & 1) {
        const uint8_t lo_n = prow[pairs] & 0x0F;
        if (lo_n) row[ez - 1] = lo_n;
      }
    }
  }
}

// 2-bit variant of paste_nibbles_3d: `packed` holds FOUR z voxels per byte,
// LSB-first (infer/packing.py pack_crumbs) — the lossless fetch encoding for
// label alphabets K <= 4 (KiTS19 kidney/tumor = 3 classes). Same np.where
// paste semantics: nonzero crumbs overwrite, zero crumbs keep the canvas.
extern "C" void paste_crumbs_3d(uint8_t* canvas, int64_t ny, int64_t nz,
                                const uint8_t* packed, int64_t sy,
                                int64_t szp, int64_t lo0, int64_t lo1,
                                int64_t lo2, int64_t ex, int64_t ey,
                                int64_t ez) {
  const int64_t quads = ez / 4;
  for (int64_t x = 0; x < ex; ++x) {
    for (int64_t y = 0; y < ey; ++y) {
      uint8_t* row = canvas + ((lo0 + x) * ny + (lo1 + y)) * nz + lo2;
      const uint8_t* prow = packed + (x * sy + y) * szp;
      for (int64_t i = 0; i < quads; ++i) {
        const uint8_t b = prow[i];
        const uint8_t c0 = b & 0x03;
        const uint8_t c1 = (b >> 2) & 0x03;
        const uint8_t c2 = (b >> 4) & 0x03;
        const uint8_t c3 = b >> 6;
        if (c0) row[4 * i] = c0;
        if (c1) row[4 * i + 1] = c1;
        if (c2) row[4 * i + 2] = c2;
        if (c3) row[4 * i + 3] = c3;
      }
      const int64_t rem = ez - quads * 4;
      if (rem) {
        const uint8_t b = prow[quads];
        for (int64_t j = 0; j < rem; ++j) {
          const uint8_t c = (b >> (2 * j)) & 0x03;
          if (c) row[4 * quads + j] = c;
        }
      }
    }
  }
}

// Per-component voxel counts and inclusive-exclusive bounding boxes in one
// pass over a label volume (labels 1..n_labels from label_components_3d).
// out_sizes: int64[n_labels]; out_boxes: int64[n_labels*6] as
// (x0,y0,z0,x1,y1,z1) with x1/y1/z1 exclusive. Empty components get size 0
// and a degenerate (0,0,0,0,0,0) box.
extern "C" void component_stats_3d(const int32_t* labels, int64_t nx,
                                   int64_t ny, int64_t nz, int32_t n_labels,
                                   int64_t* out_sizes, int64_t* out_boxes) {
  if (n_labels <= 0) return;
  for (int32_t c = 0; c < n_labels; ++c) {
    out_sizes[c] = 0;
    int64_t* b = out_boxes + static_cast<int64_t>(c) * 6;
    b[0] = nx; b[1] = ny; b[2] = nz;  // running mins
    b[3] = 0;  b[4] = 0;  b[5] = 0;   // running maxes (exclusive)
  }
  int64_t i = 0;
  for (int64_t x = 0; x < nx; ++x) {
    for (int64_t y = 0; y < ny; ++y) {
      for (int64_t z = 0; z < nz; ++z, ++i) {
        const int32_t l = labels[i];
        if (l <= 0) continue;
        out_sizes[l - 1]++;
        int64_t* b = out_boxes + static_cast<int64_t>(l - 1) * 6;
        if (x < b[0]) b[0] = x;
        if (y < b[1]) b[1] = y;
        if (z < b[2]) b[2] = z;
        if (x + 1 > b[3]) b[3] = x + 1;
        if (y + 1 > b[4]) b[4] = y + 1;
        if (z + 1 > b[5]) b[5] = z + 1;
      }
    }
  }
  for (int32_t c = 0; c < n_labels; ++c) {
    if (out_sizes[c] == 0) {
      int64_t* b = out_boxes + static_cast<int64_t>(c) * 6;
      b[0] = b[1] = b[2] = 0;
    }
  }
}

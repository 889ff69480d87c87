// Native topology kernels for the host-side "topology compiler".
//
// The reference delegates this work to PETSc DMPlex (C): transitive
// closures, patch construction, mesh entity dedup.  Our host pipeline is
// numpy-vectorised except for the two genuinely sequential algorithms
// below, which get native implementations:
//
//  * greedy_color — distance-coloring of patches by dof conflicts, the
//    enabler of ordered MULTIPLICATIVE patch sweeps on TPU (the
//    reference's patch_pc_patch_local_type multiplicative,
//    /root/reference/alfi/solver.py:321-328, becomes a sequence of
//    conflict-free additive sub-sweeps, one per color, applied in the
//    problem's relaxation direction).
//  * sorted_facet_dedup — facet table construction (row-sorted key
//    dedup), the hot spot of Mesh._build_facets for large meshes.
//
// Built as a plain shared library (g++ -shared -fPIC), loaded via
// ctypes; every entry point has a numpy fallback in topology.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Greedy coloring of `np` patches, visited in `order`, where patch p
// owns dofs csr_vals[csr_off[p]:csr_off[p+1]] (global dof ids < ndof).
// Two patches conflict iff they share a dof.  Returns #colors.
// colors must be preallocated (np).
int64_t greedy_color(int64_t npatches, int64_t ndof,
                     const int64_t* csr_off, const int64_t* csr_vals,
                     const int64_t* order, int64_t* colors) {
    // dof -> bitmask-ish: last color per dof is not enough (a dof can be
    // shared by many patches over time); we track, per dof, the set of
    // colors used by already-colored patches containing it via a
    // per-dof color list compressed as "stamp" arrays per color.
    // Simpler O(sum_p deg_p * maxcolor) approach: for each patch,
    // mark colors of all already-colored patches sharing a dof.
    std::vector<std::vector<int32_t>> dof_colors(ndof);
    std::vector<char> used;
    int64_t ncolors = 0;
    for (int64_t i = 0; i < npatches; ++i) {
        int64_t p = order ? order[i] : i;
        used.assign((size_t)ncolors + 1, 0);
        for (int64_t j = csr_off[p]; j < csr_off[p + 1]; ++j) {
            for (int32_t c : dof_colors[csr_vals[j]]) used[c] = 1;
        }
        int32_t c = 0;
        while (c < ncolors && used[c]) ++c;
        if (c == ncolors) ++ncolors;
        colors[p] = c;
        for (int64_t j = csr_off[p]; j < csr_off[p + 1]; ++j) {
            dof_colors[csr_vals[j]].push_back(c);
        }
    }
    return ncolors;
}

// Row-sorted dedup: rows (n, w) of int64, each row already sorted
// ascending.  Writes unique row ids into `inverse` (n) and unique rows
// into `unique_rows` (must be preallocated n*w; only the first
// n_unique*w entries are meaningful).  Returns n_unique.
int64_t sorted_row_dedup(int64_t n, int64_t w, const int64_t* rows,
                         int64_t* inverse, int64_t* unique_rows) {
    std::vector<int64_t> perm(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    auto cmp = [rows, w](int64_t a, int64_t b) {
        return std::lexicographical_compare(
            rows + a * w, rows + (a + 1) * w,
            rows + b * w, rows + (b + 1) * w);
    };
    std::sort(perm.begin(), perm.end(), cmp);
    auto eq = [rows, w](int64_t a, int64_t b) {
        return std::equal(rows + a * w, rows + (a + 1) * w,
                          rows + b * w);
    };
    int64_t nuniq = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (i == 0 || !eq(perm[i], perm[i - 1])) {
            std::memcpy(unique_rows + nuniq * w, rows + perm[i] * w,
                        sizeof(int64_t) * (size_t)w);
            ++nuniq;
        }
        inverse[perm[i]] = nuniq - 1;
    }
    return nuniq;
}

}  // extern "C"

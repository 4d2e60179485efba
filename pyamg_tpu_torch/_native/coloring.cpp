// First-fit greedy vertex coloring over CSR adjacency (the port's copy of
// first_fit_coloring in pyamg_tpu/_native/amg_host.cpp, after the
// reference's vertex_coloring_first_fit, graph.h:248).  Sequential O(nnz).
// The colors fix the multicolor Gauss-Seidel iterate, so this copy must
// color exactly as the reference does.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libcoloring.so coloring.cpp
// ABI: a plain C function over int32 buffers (ctypes).

#include <cstddef>
#include <cstdint>
#include <vector>

using i32 = std::int32_t;
using std::size_t;

extern "C" {

// Returns the number of colors.
i32 first_fit_coloring(i32 n, const i32* Ap, const i32* Aj, i32* color) {
    std::vector<i32> mark(64, -1);   // color -> last row that saw it
    i32 ncolors = 0;
    for (i32 i = 0; i < n; ++i) color[i] = -1;
    for (i32 i = 0; i < n; ++i) {
        for (i32 jj = Ap[i]; jj < Ap[i + 1]; ++jj) {
            i32 j = Aj[jj];
            if (j == i || j < 0 || j >= n) continue;
            i32 c = color[j];
            if (c >= 0) mark[(size_t)c] = i;
        }
        i32 c = 0;
        while (c < (i32)mark.size() && mark[(size_t)c] == i) ++c;
        if (c >= (i32)mark.size()) mark.resize((size_t)c + 1, -1);
        color[i] = c;
        if (c + 1 > ncolors) ncolors = c + 1;
    }
    return ncolors;
}

}  // extern "C"

// Standard (3-pass greedy) and naive aggregation over a CSR strength graph
// (the port's copies of standard_aggregation and naive_aggregation in
// pyamg_tpu/_native/amg_host.cpp, after the reference's
// smoothed_aggregation.h:33 and :270).  Sequential O(nnz).  The aggregates
// fix the tentative prolongator and so every coarse level, so these copies
// must aggregate exactly as the reference does.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libaggregation.so aggregation.cpp
// ABI: a plain C function over int32 buffers (ctypes).
//
//   labels out: aggregate id per node, -1 if unaggregated (isolated).
//   cpts out:   root node per aggregate (capacity n).
// Returns the number of aggregates.

#include <cstddef>
#include <cstdint>
#include <vector>

using i32 = std::int32_t;

extern "C" {

i32 standard_aggregation(i32 n, const i32* Sp, const i32* Sj, i32* labels,
                         i32* cpts) {
    std::vector<i32> x(n, 0);  // 0 = free, >0 aggregate id+1, <0 attached
    i32 next = 1;
    const i32 ISOLATED = -(n + 1);

    // pass 1: seed aggregates where no neighbor is aggregated
    for (i32 i = 0; i < n; ++i) {
        if (x[i]) continue;
        bool has_nbr = false, has_agg_nbr = false;
        for (i32 jj = Sp[i]; jj < Sp[i + 1]; ++jj) {
            i32 j = Sj[jj];
            if (j == i) continue;
            has_nbr = true;
            if (x[j]) { has_agg_nbr = true; break; }
        }
        if (!has_nbr) {
            x[i] = ISOLATED;
        } else if (!has_agg_nbr) {
            x[i] = next;
            cpts[next - 1] = i;
            for (i32 jj = Sp[i]; jj < Sp[i + 1]; ++jj) x[Sj[jj]] = next;
            ++next;
        }
    }

    // pass 2: attach stragglers to a neighboring aggregate (first found)
    for (i32 i = 0; i < n; ++i) {
        if (x[i]) continue;
        for (i32 jj = Sp[i]; jj < Sp[i + 1]; ++jj) {
            i32 xj = x[Sj[jj]];
            if (xj > 0) { x[i] = -xj; break; }
        }
    }

    i32 nagg = next - 1;

    // pass 3: leftovers seed new aggregates over their free neighbors
    for (i32 i = 0; i < n; ++i) {
        i32 xi = x[i];
        if (xi != 0) {
            if (xi > 0) labels[i] = xi - 1;
            else if (xi == ISOLATED) labels[i] = -1;
            else labels[i] = -xi - 1;
            continue;
        }
        labels[i] = nagg;
        cpts[nagg] = i;
        for (i32 jj = Sp[i]; jj < Sp[i + 1]; ++jj) {
            i32 j = Sj[jj];
            if (j != i && x[j] == 0) { labels[j] = nagg; x[j] = 1; }
        }
        x[i] = 1;
        ++nagg;
    }
    return nagg;
}

// Naive aggregation: each node not yet aggregated, in order, roots an
// aggregate of itself and its free neighbours.  Every node is aggregated.
i32 naive_aggregation(i32 n, const i32* Sp, const i32* Sj, i32* labels,
                      i32* cpts) {
    for (i32 i = 0; i < n; ++i) labels[i] = -1;
    i32 nagg = 0;
    for (i32 i = 0; i < n; ++i) {
        if (labels[i] >= 0) continue;
        labels[i] = nagg;
        cpts[nagg] = i;
        for (i32 jj = Sp[i]; jj < Sp[i + 1]; ++jj) {
            i32 j = Sj[jj];
            if (j != i && labels[j] < 0) labels[j] = nagg;
        }
        ++nagg;
    }
    return nagg;
}

}  // extern "C"

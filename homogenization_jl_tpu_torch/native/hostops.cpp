// Native host precompute kernels (C++, loaded via ctypes).
//
// The reference's performance-critical host work is its radix/counting-sort
// connectivity pipeline (src/sorting_tricks.jl:44-76, src/sparse_graph.jl).
// Here the same role is played by argsorts over packed cell keys during
// GridPlan construction - which sits inside the homogenization driver's
// domain-shrinking loop, so it is rebuilt every outer step. These kernels
// replace np.lexsort / np.unique(axis=0) with an LSD radix argsort on
// 64-bit packed keys (~5x on large meshes, single core).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable LSD radix argsort of u64 keys; writes the permutation into `order`.
void radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* order) {
    std::vector<int64_t> idx(static_cast<size_t>(n));
    std::vector<int64_t> tmp(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) idx[static_cast<size_t>(i)] = i;

    // find highest non-zero byte to skip empty passes
    uint64_t all = 0;
    for (int64_t i = 0; i < n; ++i) all |= keys[i];
    int max_pass = 0;
    while (max_pass < 8 && (all >> (8 * max_pass)) != 0) ++max_pass;
    if (max_pass == 0) max_pass = 1;

    size_t count[256];
    for (int pass = 0; pass < max_pass; ++pass) {
        const int shift = 8 * pass;
        std::memset(count, 0, sizeof(count));
        for (int64_t i = 0; i < n; ++i)
            ++count[(keys[idx[static_cast<size_t>(i)]] >> shift) & 0xff];
        size_t pos[256];
        size_t run = 0;
        for (int b = 0; b < 256; ++b) { pos[b] = run; run += count[b]; }
        for (int64_t i = 0; i < n; ++i) {
            const int64_t j = idx[static_cast<size_t>(i)];
            tmp[pos[(keys[j] >> shift) & 0xff]++] = j;
        }
        idx.swap(tmp);
    }
    std::memcpy(order, idx.data(), static_cast<size_t>(n) * sizeof(int64_t));
}

// Mark the first occurrence of each distinct key in a *sorted-by-order* key
// sequence: starts[i] = 1 iff keys[order[i]] != keys[order[i-1]].
void mark_group_starts_u64(const uint64_t* keys, const int64_t* order,
                           int64_t n, uint8_t* starts) {
    if (n == 0) return;
    starts[0] = 1;
    for (int64_t i = 1; i < n; ++i)
        starts[i] = keys[order[i]] != keys[order[i - 1]] ? 1 : 0;
}

}  // extern "C"

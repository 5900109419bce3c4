// Host-side table math and bit packing of huffman_tpu_torch, built by g++
// at first use (huffman_tpu_torch/native.py) and loaded with ctypes.
//
//  - histogram: OpenMP thread-local 256-bin arrays, then a reduction.
//  - package-merge: the coin-collector length-limited code construction,
//    bit for bit the NumPy path of core/package_merge.py (stable merge,
//    leaves before packages on ties).
//  - canonical assignment: (len asc, sym asc) order with the
//    (code+1) << (len_next - len_cur) recurrence (core/canonical.py).
//  - bit packer: the MSB-first u32 stream of core/npref.py::encode_bits.
//  - prefix-code walk: a flat-LUT sequential decode of any prefix code,
//    canonical or not (io/seqfmt.py::host_lut_decode).
//
// A plain C ABI; the same functions and results as the JAX package's
// native module, version 2.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// Histogram
// ---------------------------------------------------------------------
void hn_histogram(const uint8_t* data, int64_t n, int64_t out[256]) {
    std::memset(out, 0, 256 * sizeof(int64_t));
#ifdef _OPENMP
#pragma omp parallel
    {
        int64_t local[256] = {0};
#pragma omp for nowait
        for (int64_t i = 0; i < n; i++) local[data[i]]++;
#pragma omp critical
        for (int j = 0; j < 256; j++) out[j] += local[j];
    }
#else
    for (int64_t i = 0; i < n; i++) out[data[i]]++;
#endif
}

// ---------------------------------------------------------------------
// Package-merge (coin collector), as core/package_merge.py
// ---------------------------------------------------------------------
// Returns 0 on success, negative on error.
int hn_package_merge(const int64_t freqs[256], int max_len, uint8_t lengths[256]) {
    std::memset(lengths, 0, 256);
    int syms[256];
    int k = 0;
    for (int s = 0; s < 256; s++) {
        if (freqs[s] < 0) return -1;
        if (freqs[s] > 0) syms[k++] = s;
    }
    if (k == 0) return 0;
    if (k == 1) {
        lengths[syms[0]] = 1;
        return 0;
    }
    if (max_len < 1 || max_len > 32 || (int64_t)k > (int64_t(1) << max_len))
        return -2;

    // stable sort symbols by frequency ascending (indices tie-break)
    int order[256];
    for (int i = 0; i < k; i++) order[i] = i;
    // insertion sort is fine for 256 elements and is stable
    for (int i = 1; i < k; i++) {
        int oi = order[i];
        int64_t wi = freqs[syms[oi]];
        int j = i - 1;
        while (j >= 0 && freqs[syms[order[j]]] > wi) {
            order[j + 1] = order[j];
            j--;
        }
        order[j + 1] = oi;
    }
    std::vector<int> sorted_syms(k);
    std::vector<int64_t> w(k);
    for (int i = 0; i < k; i++) {
        sorted_syms[i] = syms[order[i]];
        w[i] = freqs[sorted_syms[i]];
    }

    // package lists: weights + per-symbol leaf counts (k counters each)
    struct Level {
        std::vector<int64_t> pw;
        std::vector<uint16_t> pc;  // (len, k) row-major
    };
    Level cur;
    cur.pw = w;
    cur.pc.assign((size_t)k * k, 0);
    for (int i = 0; i < k; i++) cur.pc[(size_t)i * k + i] = 1;

    for (int level = 0; level < max_len - 1; level++) {
        size_t p = cur.pw.size() & ~size_t(1);
        size_t n_m = p / 2;
        // merged packages (weights ascending since input ascending)
        std::vector<int64_t> mw(n_m);
        std::vector<uint16_t> mc((size_t)n_m * k, 0);
        for (size_t i = 0; i < n_m; i++) {
            mw[i] = cur.pw[2 * i] + cur.pw[2 * i + 1];
            uint16_t* dst = &mc[i * k];
            const uint16_t* a = &cur.pc[(2 * i) * (size_t)k];
            const uint16_t* b = &cur.pc[(2 * i + 1) * (size_t)k];
            for (int j = 0; j < k; j++) dst[j] = (uint16_t)(a[j] + b[j]);
        }
        // stable merge of leaves (first on ties) with merged packages
        Level nxt;
        nxt.pw.resize((size_t)k + n_m);
        nxt.pc.assign(((size_t)k + n_m) * k, 0);
        size_t ia = 0, ib = 0, io = 0;
        while (ia < (size_t)k || ib < n_m) {
            bool take_leaf =
                ib >= n_m || (ia < (size_t)k && w[ia] <= mw[ib]);
            if (take_leaf) {
                nxt.pw[io] = w[ia];
                nxt.pc[io * k + ia] = 1;
                ia++;
            } else {
                nxt.pw[io] = mw[ib];
                std::memcpy(&nxt.pc[io * k], &mc[ib * (size_t)k],
                            (size_t)k * sizeof(uint16_t));
                ib++;
            }
            io++;
        }
        cur = std::move(nxt);
    }

    size_t take = (size_t)(2 * k - 2);
    for (int j = 0; j < k; j++) {
        int64_t len = 0;
        for (size_t i = 0; i < take; i++) len += cur.pc[i * (size_t)k + j];
        if (len <= 0 || len > max_len) return -3;
        lengths[sorted_syms[j]] = (uint8_t)len;
    }
    return 0;
}

// ---------------------------------------------------------------------
// Canonical assignment (len asc, sym asc) — canonical.py semantics
// ---------------------------------------------------------------------
int hn_canonical(const uint8_t lengths[256], uint32_t codes[256],
                 uint8_t symtab[256], int* n_sym) {
    std::memset(codes, 0, 256 * sizeof(uint32_t));
    int n = 0;
    for (int l = 1; l <= 32; l++)
        for (int s = 0; s < 256; s++)
            if (lengths[s] == l) symtab[n++] = (uint8_t)s;
    *n_sym = n;
    if (n == 0) return 0;
    uint64_t kraft = 0;
    int max_l = 0;
    for (int i = 0; i < n; i++)
        if (lengths[symtab[i]] > max_l) max_l = lengths[symtab[i]];
    for (int i = 0; i < n; i++)
        kraft += uint64_t(1) << (max_l - lengths[symtab[i]]);
    if (kraft > (uint64_t(1) << max_l)) return -1;
    uint32_t c = 0;
    int prev = lengths[symtab[0]];
    codes[symtab[0]] = 0;
    for (int i = 1; i < n; i++) {
        int l = lengths[symtab[i]];
        c = (c + 1) << (l - prev);
        prev = l;
        codes[symtab[i]] = c;
    }
    return 0;
}

// ---------------------------------------------------------------------
// MSB-first u32 bit packer (npref.encode_bits semantics)
// ---------------------------------------------------------------------
// words must have space for ceil(total_bits/32) + 1 entries, zeroed by the
// caller or not (it is fully overwritten here). Returns total_bits, or
// negative on error (absent symbol).
int64_t hn_encode_bits(const uint8_t* data, int64_t n,
                       const uint32_t codes[256], const uint8_t lens[256],
                       uint32_t* words, int64_t n_words) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) {
        if (lens[data[i]] == 0) return -1;
        total += lens[data[i]];
    }
    int64_t need = (total + 31) / 32 + 1;
    if (need > n_words) return -2;
    std::memset(words, 0, (size_t)need * 4);
    uint64_t acc = 0;  // bits accumulate MSB-first in the top of acc
    int used = 0;
    int64_t wi = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = data[i];
        int l = lens[b];
        acc |= (uint64_t)codes[b] << (64 - used - l);
        used += l;
        if (used >= 32) {
            words[wi++] = (uint32_t)(acc >> 32);
            acc <<= 32;
            used -= 32;
        }
    }
    if (used > 0) words[wi++] = (uint32_t)(acc >> 32);
    return total;
}

// ---------------------------------------------------------------------
// Sequential prefix-code LUT walk (arbitrary, possibly non-canonical codes)
// ---------------------------------------------------------------------
// The role of the reference sequential decoder's bit-by-bit loop at native
// speed: foreign greedy-tree codes are not canonical, so the device
// decoders cannot take them. lut_sym/lut_len have 2^lut_bits entries (flat
// LUT, every codeword replicated across its suffix range). Returns the
// symbol count, or negative on error (no codeword matches / output
// overflow).
int64_t hn_decode_prefix_lut(const uint8_t* payload, int64_t n_bytes,
                             int64_t total_bits,
                             const uint8_t* lut_sym, const uint8_t* lut_len,
                             int lut_bits,
                             uint8_t* out, int64_t out_cap) {
    if (lut_bits < 1 || lut_bits > 24) return -3;
    int64_t pos = 0, no = 0;
    while (pos < total_bits) {
        int64_t byte = pos >> 3;
        uint64_t w = 0;
        if (byte + 8 <= n_bytes) {
            // big-endian load: MSB-first bitstream
            std::memcpy(&w, payload + byte, 8);
            w = __builtin_bswap64(w);
        } else {
            for (int j = 0; j < 8; j++)
                w = (w << 8) | (byte + j < n_bytes ? payload[byte + j] : 0);
        }
        uint32_t idx = (uint32_t)((w << (pos & 7)) >> (64 - lut_bits));
        int l = lut_len[idx];
        if (l == 0) return -1;
        if (no >= out_cap) return -2;
        out[no++] = lut_sym[idx];
        pos += l;
    }
    return no;
}

int hn_version(void) { return 2; }

}  // extern "C"

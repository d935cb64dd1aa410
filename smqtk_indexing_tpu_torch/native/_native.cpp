// Host-side native runtime for smqtk_indexing_tpu_torch: a copy of
// smqtk_indexing_tpu/native/_native.cpp, so that the port builds its own.
//
// The reference delegated all native compute to external C++ libraries
// (FAISS / FLANN / sklearn — SURVEY.md §2.6). In the TPU build the heavy
// compute lives on-device; what remains genuinely hot on the HOST are the
// glue paths this file serves:
//
//   * bit packing/unpacking between boolean hash matrices and the packed
//     uint32 device format (every LSH build/update crosses this boundary);
//   * small-index Hamming top-k (below a few thousand codes the device
//     round-trip latency exceeds the scan cost, so LinearHashIndex serves
//     tiny indexes from the host mirror);
//   * fvecs/bvecs benchmark-dataset readers (SIFT1M/GIST1M container
//     format) with a single-pass parse.
//
// Exposed as plain C symbols (ctypes-loadable; no pybind11 dependency).
// Build: g++ -O3 -march=native -shared -fPIC (driven by native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Pack a row-major (n, bits) uint8 boolean matrix into (n, words) uint32,
// bit i of a row landing in word i/32 at bit position matching
// numpy.packbits big-endian-byte order viewed as native uint32 words
// (see utils/bits.pack_bit_vectors_u32).
void pack_bits_u32(const uint8_t* bools, int64_t n, int64_t bits,
                   uint32_t* out) {
    const int64_t words = (bits + 31) / 32;
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* row = bools + r * bits;
        uint32_t* orow = out + r * words;
        std::memset(orow, 0, words * sizeof(uint32_t));
        for (int64_t i = 0; i < bits; ++i) {
            if (row[i]) {
                // numpy.packbits: bit i -> byte i/8, MSB-first within the
                // byte; bytes then viewed as native-endian uint32.
                const int64_t byte_idx = i / 8;
                const int bit_in_byte = 7 - static_cast<int>(i % 8);
                reinterpret_cast<uint8_t*>(orow)[byte_idx] |=
                    static_cast<uint8_t>(1u << bit_in_byte);
            }
        }
    }
}

// Inverse of pack_bits_u32.
void unpack_bits_u32(const uint32_t* packed, int64_t n, int64_t bits,
                     uint8_t* out) {
    const int64_t words = (bits + 31) / 32;
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* prow =
            reinterpret_cast<const uint8_t*>(packed + r * words);
        uint8_t* orow = out + r * bits;
        for (int64_t i = 0; i < bits; ++i) {
            const int64_t byte_idx = i / 8;
            const int bit_in_byte = 7 - static_cast<int>(i % 8);
            orow[i] = (prow[byte_idx] >> bit_in_byte) & 1u;
        }
    }
}

// Exhaustive Hamming top-k over packed codes: for each of b queries,
// XOR+popcount the n codes (words words each), respecting the liveness
// mask, and emit the k smallest (distance, row) pairs ascending.
// out_d / out_r are (b, k); unfilled slots get dist INT32_MAX, row -1.
void hamming_topk_host(const uint32_t* db, const uint8_t* valid,
                       const uint32_t* q, int64_t n, int64_t words,
                       int64_t b, int64_t k, int32_t* out_d,
                       int32_t* out_r) {
    std::vector<std::pair<int32_t, int32_t>> heap;  // max-heap of k best
    for (int64_t qi = 0; qi < b; ++qi) {
        const uint32_t* qrow = q + qi * words;
        heap.clear();
        for (int64_t r = 0; r < n; ++r) {
            if (!valid[r]) continue;
            const uint32_t* drow = db + r * words;
            int32_t dist = 0;
            for (int64_t w = 0; w < words; ++w)
                dist += __builtin_popcount(qrow[w] ^ drow[w]);
            if (static_cast<int64_t>(heap.size()) < k) {
                heap.emplace_back(dist, static_cast<int32_t>(r));
                std::push_heap(heap.begin(), heap.end());
            } else if (dist < heap.front().first) {
                std::pop_heap(heap.begin(), heap.end());
                heap.back() = {dist, static_cast<int32_t>(r)};
                std::push_heap(heap.begin(), heap.end());
            }
        }
        std::sort_heap(heap.begin(), heap.end());
        int32_t* od = out_d + qi * k;
        int32_t* orow = out_r + qi * k;
        for (int64_t i = 0; i < k; ++i) {
            if (i < static_cast<int64_t>(heap.size())) {
                od[i] = heap[i].first;
                orow[i] = heap[i].second;
            } else {
                od[i] = INT32_MAX;
                orow[i] = -1;
            }
        }
    }
}

// fvecs/bvecs reader (TexMex corpus container: per row a little-endian
// int32 dim followed by dim float32s / uint8s). Returns rows read, or -1
// on open failure, -2 on malformed row. Reads at most max_n rows into out
// ((max_n, dim) float32); dim must match the file's leading dim.
int64_t read_fvecs(const char* path, int64_t max_n, int64_t dim,
                   float* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t r = 0;
    for (; r < max_n; ++r) {
        int32_t d = 0;
        if (std::fread(&d, sizeof(int32_t), 1, f) != 1) break;  // EOF
        if (d != dim) { std::fclose(f); return -2; }
        if (std::fread(out + r * dim, sizeof(float),
                       static_cast<size_t>(d), f)
            != static_cast<size_t>(d)) {
            std::fclose(f);
            return -2;
        }
    }
    std::fclose(f);
    return r;
}

int64_t read_bvecs(const char* path, int64_t max_n, int64_t dim,
                   float* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::vector<uint8_t> buf(static_cast<size_t>(dim));
    int64_t r = 0;
    for (; r < max_n; ++r) {
        int32_t d = 0;
        if (std::fread(&d, sizeof(int32_t), 1, f) != 1) break;
        if (d != dim) { std::fclose(f); return -2; }
        if (std::fread(buf.data(), 1, static_cast<size_t>(d), f)
            != static_cast<size_t>(d)) {
            std::fclose(f);
            return -2;
        }
        float* orow = out + r * dim;
        for (int64_t i = 0; i < dim; ++i)
            orow[i] = static_cast<float>(buf[i]);
    }
    std::fclose(f);
    return r;
}

}  // extern "C"

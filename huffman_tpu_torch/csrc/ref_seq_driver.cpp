// File driver around the reference's sequential codec (`sequential.cpp`).
//
// The reference round-trips only in memory; its compressed blob never
// reaches a file, so binary interop cannot be checked against its stock
// binary.  This driver #includes the reference source as it is at compile
// time (its path given by -DREF_SEQ_SOURCE, its `main` renamed by the
// preprocessor) and exposes file-based encode and decode:
//
//     ref_seq encode <in> <out>   # reference HuffmanSequential::encode
//     ref_seq decode <in> <out>   # reference HuffmanSequential::decode
//
// Built on demand by huffman_tpu_torch/io/refbin.py, which skips where the
// reference source or g++ is absent.  No reference code lives in this repo.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

#define main ref_seq_reference_main
#include REF_SEQ_SOURCE
#undef main

static std::vector<uint8_t> slurp(const char* path) {
    std::ifstream in(path, std::ios::binary | std::ios::ate);
    if (!in) { std::fprintf(stderr, "cannot open %s\n", path); std::exit(2); }
    std::streamsize size = in.tellg();
    std::vector<uint8_t> buf((size_t)size);
    in.seekg(0, std::ios::beg);
    if (size && !in.read(reinterpret_cast<char*>(buf.data()), size)) {
        std::fprintf(stderr, "read failed: %s\n", path);
        std::exit(2);
    }
    return buf;
}

static void spit(const char* path, const std::vector<uint8_t>& v) {
    std::ofstream out(path, std::ios::binary);
    if (!out || (!v.empty() &&
                 !out.write(reinterpret_cast<const char*>(v.data()),
                            (std::streamsize)v.size()))) {
        std::fprintf(stderr, "write failed: %s\n", path);
        std::exit(2);
    }
}

int main(int argc, char** argv) {
    if (argc != 4) {
        std::fprintf(stderr, "usage: %s encode|decode <in> <out>\n", argv[0]);
        return 2;
    }
    HuffmanSequential h;
    std::vector<uint8_t> in = slurp(argv[2]);
    std::vector<uint8_t> out;
    if (!std::strcmp(argv[1], "encode")) {
        out = h.encode(in);
    } else if (!std::strcmp(argv[1], "decode")) {
        out = h.decode(in);
    } else {
        std::fprintf(stderr, "unknown mode %s\n", argv[1]);
        return 2;
    }
    spit(argv[3], out);
    return 0;
}

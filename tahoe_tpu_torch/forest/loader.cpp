// Native parser of the reference's text formats (forest/io.py), host C++.
//
// The port's copy of csrc/loader.cpp, the JAX package's counterpart of the
// reference's C++ loaders (BaseTahoeTest.h:267-352, 354-402): one strtod
// scan of the file, about 20x faster than numpy's loadtxt on the reference's
// files of millions of lines. A C interface bound by ctypes
// (forest/native_io.py), built by the host's c++ at first use, apart from
// the CUDA kernels. The file is read whole into a buffer with a NUL after
// it, so that strtod never reads past the last number.
//
//   model: num_trees, depth + 1, then 5 lines a node in heap order
//          (fid, value, def_left, weight, is_leaf)
//   data:  num_rows, num_cols, the missing sentinel, then one value a line,
//          row-major
//
// Every entry point returns 0, or -1 (the file cannot be read), -2 (no
// header) or -3 (fewer values than the header promises).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <memory>

#define TAHOE_IO_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

struct Text {
    std::unique_ptr<char[]> data;
    const char* p = nullptr;
    bool ok() const { return p != nullptr; }
};

Text read_file(const char* path) {
    Text t;
    FILE* f = std::fopen(path, "rb");
    if (f == nullptr) return t;
    if (std::fseek(f, 0, SEEK_END) == 0) {
        const long size = std::ftell(f);
        if (size > 0 && std::fseek(f, 0, SEEK_SET) == 0) {
            t.data.reset(new char[size + 1]);
            if (std::fread(t.data.get(), 1, size, f) == static_cast<size_t>(size)) {
                t.data[size] = '\0';
                t.p = t.data.get();
            }
        }
    }
    std::fclose(f);
    return t;
}

// The next number, skipping whitespace; false at the end or on garbage.
inline bool next_double(const char*& p, double* out) {
    while (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t') ++p;
    if (*p == '\0') return false;
    char* end = nullptr;
    errno = 0;
    const double v = std::strtod(p, &end);
    if (end == p) return false;
    p = end;
    *out = v;
    return true;
}

inline bool next_long(const char*& p, long* out) {
    double v;
    if (!next_double(p, &v)) return false;
    *out = static_cast<long>(v);
    return true;
}

}  // namespace

TAHOE_IO_EXPORT int tahoe_model_header(const char* path, int64_t* num_trees,
                                       int64_t* depth) {
    Text t = read_file(path);
    if (!t.ok()) return -1;
    long n = 0, d = 0;
    if (!next_long(t.p, &n) || !next_long(t.p, &d)) return -2;
    *num_trees = n;
    *depth = d - 1;  // the file stores depth + 1 (BaseTahoeTest.h:282)
    return 0;
}

TAHOE_IO_EXPORT int tahoe_model_load(const char* path, int64_t nodes, int32_t* fids,
                                     float* values, uint8_t* def_left,
                                     float* weights, uint8_t* is_leaf) {
    Text t = read_file(path);
    if (!t.ok()) return -1;
    long n = 0, d = 0;
    if (!next_long(t.p, &n) || !next_long(t.p, &d)) return -2;
    for (int64_t i = 0; i < nodes; ++i) {
        long fid, dl, lf;
        double v, w;
        if (!next_long(t.p, &fid) || !next_double(t.p, &v) || !next_long(t.p, &dl) ||
            !next_double(t.p, &w) || !next_long(t.p, &lf))
            return -3;
        fids[i] = static_cast<int32_t>(fid);
        values[i] = static_cast<float>(v);
        def_left[i] = dl ? 1 : 0;
        weights[i] = static_cast<float>(w);
        is_leaf[i] = lf ? 1 : 0;
    }
    return 0;
}

TAHOE_IO_EXPORT int tahoe_data_header(const char* path, int64_t* num_rows,
                                      int64_t* num_cols, double* missing) {
    Text t = read_file(path);
    if (!t.ok()) return -1;
    long r = 0, c = 0;
    double m = 0.0;
    if (!next_long(t.p, &r) || !next_long(t.p, &c) || !next_double(t.p, &m)) return -2;
    *num_rows = r;
    *num_cols = c;
    *missing = m;
    return 0;
}

TAHOE_IO_EXPORT int tahoe_data_load(const char* path, int64_t count, float* out) {
    Text t = read_file(path);
    if (!t.ok()) return -1;
    long r, c;
    double m;
    if (!next_long(t.p, &r) || !next_long(t.p, &c) || !next_double(t.p, &m)) return -2;
    for (int64_t i = 0; i < count; ++i) {
        double v;
        if (!next_double(t.p, &v)) return -3;
        out[i] = static_cast<float>(v);
    }
    return 0;
}

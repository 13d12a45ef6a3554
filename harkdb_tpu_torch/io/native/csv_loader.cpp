// Native CSV loader — parallel two-pass numeric CSV parser.
//
// A copy of harkdb_tpu/io/native/csv_loader.cpp with the same C interface.
// The reference ingests CSV via pandas (`table.py:29-32`); at scale that is a
// single-threaded Python-object path. This loader mmaps the file, splits it at
// newline boundaries across hardware threads, and parses numeric fields
// straight into a column-major double buffer (each column is later cast to
// int32/float32 by the Python dtype policy). No third-party deps; C++17.
//
// Exposed C ABI (used via ctypes from harkdb_tpu_torch.io.native_csv):
//   hark_csv_dims(path, &rows, &cols, header_buf, header_cap) -> 0 on success
//   hark_csv_parse(path, out_colmajor, rows, cols)            -> 0 on success

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) { ::close(fd); return false; }
        size = static_cast<size_t>(st.st_size);
        if (size == 0) { data = nullptr; return true; }
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { ::close(fd); return false; }
        madvise(p, size, MADV_SEQUENTIAL);
        data = static_cast<const char*>(p);
        return true;
    }
    ~MappedFile() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

// Parse one double starting at p; advances p past the number.
inline double parse_number(const char*& p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    double v = 0.0;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10.0 + (*p - '0');
        ++p;
    }
    if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        while (p < end && *p >= '0' && *p <= '9') {
            v += (*p - '0') * scale;
            scale *= 0.1;
            ++p;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
        int ex = 0;
        while (p < end && *p >= '0' && *p <= '9') { ex = ex * 10 + (*p - '0'); ++p; }
        double f = 1.0;
        while (ex--) f *= 10.0;
        v = eneg ? v / f : v * f;
    }
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    return neg ? -v : v;
}

// First data byte (after the header line).
const char* data_start(const MappedFile& mf) {
    const char* nl = static_cast<const char*>(
        memchr(mf.data, '\n', mf.size));
    return nl ? nl + 1 : mf.data + mf.size;
}

}  // namespace

extern "C" {

// Count rows/cols and copy the header line into header_buf (NUL-terminated).
int hark_csv_dims(const char* path, int64_t* rows, int64_t* cols,
                  char* header_buf, int64_t header_cap) {
    MappedFile mf;
    if (!mf.open(path) || mf.size == 0) return 1;
    const char* nl = static_cast<const char*>(memchr(mf.data, '\n', mf.size));
    if (!nl) return 2;
    int64_t hlen = nl - mf.data;
    if (hlen > 0 && mf.data[hlen - 1] == '\r') --hlen;
    if (hlen + 1 > header_cap) return 3;
    memcpy(header_buf, mf.data, hlen);
    header_buf[hlen] = '\0';
    int64_t c = 1;
    for (int64_t i = 0; i < hlen; ++i)
        if (header_buf[i] == ',') ++c;
    *cols = c;

    // Parallel newline count over the data region.
    const char* start = nl + 1;
    size_t dlen = mf.data + mf.size - start;
    unsigned nt = std::max(1u, std::thread::hardware_concurrency());
    if (dlen < (1u << 20)) nt = 1;
    std::vector<int64_t> counts(nt, 0);
    std::vector<std::thread> ts;
    size_t chunk = dlen / nt + 1;
    for (unsigned t = 0; t < nt; ++t) {
        ts.emplace_back([&, t] {
            const char* p = start + std::min(static_cast<size_t>(t) * chunk, dlen);
            const char* e = start + std::min(static_cast<size_t>(t + 1) * chunk, dlen);
            int64_t n = 0;
            while (p < e) {
                const char* q = static_cast<const char*>(memchr(p, '\n', e - p));
                if (!q) break;
                ++n;
                p = q + 1;
            }
            counts[t] = n;
        });
    }
    for (auto& th : ts) th.join();
    int64_t r = 0;
    for (auto v : counts) r += v;
    // Final line without trailing newline.
    if (dlen > 0 && start[dlen - 1] != '\n') ++r;
    *rows = r;
    return 0;
}

// Parse the data region into out (column-major: out[col*rows + row]).
int hark_csv_parse(const char* path, double* out, int64_t rows, int64_t cols) {
    MappedFile mf;
    if (!mf.open(path) || mf.size == 0) return 1;
    const char* start = data_start(mf);
    const char* end = mf.data + mf.size;
    size_t dlen = end - start;

    unsigned nt = std::max(1u, std::thread::hardware_concurrency());
    if (dlen < (1u << 20)) nt = 1;

    // Chunk boundaries snapped to newline starts; each thread needs its
    // starting global row index, so first locate boundaries + row offsets.
    std::vector<const char*> bounds(nt + 1);
    bounds[0] = start;
    size_t chunk = dlen / nt + 1;
    for (unsigned t = 1; t < nt; ++t) {
        const char* p = start + std::min(static_cast<size_t>(t) * chunk, dlen);
        const char* q = static_cast<const char*>(memchr(p, '\n', end - p));
        bounds[t] = q ? q + 1 : end;
    }
    bounds[nt] = end;

    std::vector<int64_t> row_off(nt + 1, 0);
    {
        std::vector<int64_t> counts(nt, 0);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t) {
            ts.emplace_back([&, t] {
                int64_t n = 0;
                const char* p = bounds[t];
                const char* e = bounds[t + 1];
                while (p < e) {
                    const char* q = static_cast<const char*>(memchr(p, '\n', e - p));
                    if (!q) { ++n; break; }
                    ++n;
                    p = q + 1;
                }
                counts[t] = n;
            });
        }
        for (auto& th : ts) th.join();
        for (unsigned t = 0; t < nt; ++t) row_off[t + 1] = row_off[t] + counts[t];
    }
    if (row_off[nt] != rows) return 4;

    std::atomic<int> err{0};
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nt; ++t) {
        ts.emplace_back([&, t] {
            const char* p = bounds[t];
            const char* e = bounds[t + 1];
            int64_t row = row_off[t];
            while (p < e && row < rows) {
                const char* line_end = static_cast<const char*>(
                    memchr(p, '\n', e - p));
                if (!line_end) line_end = e;
                for (int64_t c = 0; c < cols; ++c) {
                    out[c * rows + row] = parse_number(p, line_end);
                    if (c + 1 < cols) {
                        if (p < line_end && *p == ',') ++p;
                        else { err.store(5); return; }
                    }
                }
                ++row;
                p = line_end + 1;
            }
        });
    }
    for (auto& th : ts) th.join();
    return err.load();
}

}  // extern "C"

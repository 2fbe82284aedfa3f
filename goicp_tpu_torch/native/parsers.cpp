// Native text parsers for the data formats the sweep reads per pair:
// .mol2 ATOM blocks and .cfpfh descriptor tables.
//
// Port of goicp_tpu/native/parsers.cpp.  The reference parses these with
// C++ iostreams (transformation.cpp, jly_main.cpp:272-314); here the
// parsers are batched (whole-file buffers, strtod scans) and exposed via a
// C ABI for ctypes.
//
// Built by goicp_tpu_torch/_build.py::host_library at first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = std::fread(&(*out)[0], 1, n, f);
  std::fclose(f);
  out->resize(got);
  return true;
}

}  // namespace

extern "C" {

// Parse the @<TRIPOS>ATOM block: writes up to max_n rows of xyz into
// coords (3*n) and the atom-name column into names (8 bytes per row,
// NUL-padded).  Returns the number of atoms, or -1 on error.
int64_t parse_mol2_atoms(const char* path, int64_t max_n, double* coords,
                         char* names) {
  std::string buf;
  if (!read_file(path, &buf)) return -1;
  const char* p = std::strstr(buf.c_str(), "@<TRIPOS>ATOM");
  if (!p) return -1;
  p = std::strchr(p, '\n');
  if (!p) return -1;
  ++p;
  int64_t n = 0;
  while (*p && n < max_n) {
    if (*p == '@') break;  // next section
    // columns: id name x y z ...
    char* end;
    std::strtol(p, &end, 10);
    if (end == p) break;
    p = end;
    while (*p == ' ' || *p == '\t') ++p;
    const char* name_start = p;
    while (*p && *p != ' ' && *p != '\t') ++p;
    size_t name_len = std::min<size_t>(p - name_start, 7);
    std::memset(names + n * 8, 0, 8);
    std::memcpy(names + n * 8, name_start, name_len);
    for (int d = 0; d < 3; ++d) {
      coords[n * 3 + d] = std::strtod(p, &end);
      if (end == p) return n;
      p = end;
    }
    ++n;
    const char* nl = std::strchr(p, '\n');
    if (!nl) break;
    p = nl + 1;
  }
  return n;
}

// Parse a whitespace-separated float table (cfpfh / xyz bodies).
// Returns number of values written (up to max_vals).
int64_t parse_float_table(const char* path, int64_t max_vals, double* out) {
  std::string buf;
  if (!read_file(path, &buf)) return -1;
  const char* p = buf.c_str();
  char* end;
  int64_t n = 0;
  while (n < max_vals) {
    double v = std::strtod(p, &end);
    if (end == p) break;
    out[n++] = v;
    p = end;
  }
  return n;
}

}  // extern "C"

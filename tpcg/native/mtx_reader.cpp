// Native Matrix Market reader for tpcg.
//
// Native replacement for the reference's BeBOP Sparse Matrix Converter
// dependency (main.c:8-33): parses coordinate-format Matrix Market files
// (real / complex / integer / pattern, general / symmetric / hermitian /
// skew-symmetric), expands symmetric storage, and emits sorted CSR.
// Exposed through a C ABI consumed via ctypes (tpcg/native/mtx_native.py).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <complex>
#include <string>
#include <vector>

namespace {

struct MtxMatrix {
  int64_t nrows = 0;
  int64_t ncols = 0;
  bool is_complex = false;
  // CSR, sorted by (row, col), duplicates summed.
  std::vector<int64_t> indptr;
  std::vector<int64_t> indices;
  std::vector<std::complex<double>> values;
};

struct Entry {
  int64_t r, c;
  std::complex<double> v;
};

bool parse_header(FILE* f, bool* is_complex, bool* is_pattern, int* symmetry) {
  // symmetry: 0 general, 1 symmetric, 2 hermitian, 3 skew-symmetric
  char line[1024];
  if (!fgets(line, sizeof line, f)) return false;
  std::string hdr(line);
  for (auto& ch : hdr) ch = std::tolower(ch);
  if (hdr.rfind("%%matrixmarket", 0) != 0) return false;
  if (hdr.find("matrix") == std::string::npos) return false;
  if (hdr.find("coordinate") == std::string::npos) return false;  // no dense
  *is_complex = hdr.find("complex") != std::string::npos;
  *is_pattern = hdr.find("pattern") != std::string::npos;
  if (hdr.find("skew-symmetric") != std::string::npos)
    *symmetry = 3;
  else if (hdr.find("hermitian") != std::string::npos)
    *symmetry = 2;
  else if (hdr.find("symmetric") != std::string::npos)
    *symmetry = 1;
  else
    *symmetry = 0;
  return true;
}

MtxMatrix* read_mtx(const char* path) {
  FILE* f = std::fopen(path, "r");
  if (!f) return nullptr;
  bool is_complex = false, is_pattern = false;
  int symmetry = 0;
  if (!parse_header(f, &is_complex, &is_pattern, &symmetry)) {
    std::fclose(f);
    return nullptr;
  }
  char line[4096];
  // skip comments
  long pos;
  do {
    pos = std::ftell(f);
    if (!fgets(line, sizeof line, f)) {
      std::fclose(f);
      return nullptr;
    }
  } while (line[0] == '%');
  int64_t nrows, ncols, nnz;
  if (std::sscanf(line, "%ld %ld %ld", &nrows, &ncols, &nnz) != 3) {
    std::fclose(f);
    return nullptr;
  }
  std::vector<Entry> entries;
  entries.reserve(symmetry ? 2 * nnz : nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    if (!fgets(line, sizeof line, f)) {
      std::fclose(f);
      return nullptr;
    }
    char* p = line;
    int64_t r = std::strtoll(p, &p, 10) - 1;  // 1-based in the file
    int64_t c = std::strtoll(p, &p, 10) - 1;
    double re = 1.0, im = 0.0;
    if (!is_pattern) {
      re = std::strtod(p, &p);
      if (is_complex) im = std::strtod(p, &p);
    }
    if (r < 0 || r >= nrows || c < 0 || c >= ncols) {
      std::fclose(f);
      return nullptr;
    }
    std::complex<double> v(re, im);
    entries.push_back({r, c, v});
    if (symmetry != 0 && r != c) {
      std::complex<double> vt = v;
      if (symmetry == 2) vt = std::conj(v);
      if (symmetry == 3) vt = -v;
      entries.push_back({c, r, vt});
    }
  }
  std::fclose(f);

  std::sort(entries.begin(), entries.end(), [](const Entry& a, const Entry& b) {
    return a.r != b.r ? a.r < b.r : a.c < b.c;
  });

  auto* out = new MtxMatrix;
  out->nrows = nrows;
  out->ncols = ncols;
  out->is_complex = is_complex;
  out->indptr.assign(nrows + 1, 0);
  out->indices.reserve(entries.size());
  out->values.reserve(entries.size());
  for (size_t i = 0; i < entries.size();) {
    size_t j = i + 1;
    std::complex<double> acc = entries[i].v;
    while (j < entries.size() && entries[j].r == entries[i].r &&
           entries[j].c == entries[i].c) {
      acc += entries[j].v;  // sum duplicates, like scipy / BeBOP
      ++j;
    }
    out->indices.push_back(entries[i].c);
    out->values.push_back(acc);
    out->indptr[entries[i].r + 1]++;
    i = j;
  }
  for (int64_t r = 0; r < nrows; ++r) out->indptr[r + 1] += out->indptr[r];
  return out;
}

}  // namespace

extern "C" {

void* tpcg_mtx_read(const char* path) { return read_mtx(path); }

int64_t tpcg_mtx_nrows(void* h) { return static_cast<MtxMatrix*>(h)->nrows; }
int64_t tpcg_mtx_ncols(void* h) { return static_cast<MtxMatrix*>(h)->ncols; }
int64_t tpcg_mtx_nnz(void* h) {
  return static_cast<int64_t>(static_cast<MtxMatrix*>(h)->values.size());
}
int tpcg_mtx_is_complex(void* h) {
  return static_cast<MtxMatrix*>(h)->is_complex ? 1 : 0;
}

// indptr: int64[nrows+1]; indices: int64[nnz];
// data: complex128[nnz] if complex else float64[nnz].
void tpcg_mtx_fill_csr(void* h, void* indptr, void* indices, void* data) {
  auto* m = static_cast<MtxMatrix*>(h);
  std::memcpy(indptr, m->indptr.data(), m->indptr.size() * sizeof(int64_t));
  std::memcpy(indices, m->indices.data(), m->indices.size() * sizeof(int64_t));
  if (m->is_complex) {
    std::memcpy(data, m->values.data(),
                m->values.size() * sizeof(std::complex<double>));
  } else {
    auto* d = static_cast<double*>(data);
    for (size_t i = 0; i < m->values.size(); ++i) d[i] = m->values[i].real();
  }
}

void tpcg_mtx_free(void* h) { delete static_cast<MtxMatrix*>(h); }

}  // extern "C"

// Native multi-threaded text data loader.
//
// The port's copy of lightgbmv1_tpu/native/text_parser.cpp, the
// counterpart of the reference's C++ IO stack (reference:
// src/io/parser.cpp CSVParser/TSVParser, include/LightGBM/utils/text_reader.h
// chunked TextReader, src/io/dataset_loader.cpp line handling): reads a
// dense CSV/TSV/whitespace table into a row-major double matrix with
// parallel line indexing and parallel field parsing.
//
// Exposed through a plain C ABI consumed via ctypes (lightgbmv1_tpu_torch/
// native/__init__.py) — no pybind11 dependency.  Semantics mirror the Python
// parser exactly (io/parser.py _parse_dense): '#' starts a comment,
// blank lines are skipped, and the tokens ""/na/nan/NA/NaN/null parse as
// NaN.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <limits>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ParsedFile {
  std::string data;
  std::vector<std::pair<size_t, size_t>> lines;  // begin, end offsets
  long rows = 0;
  long cols = 0;
  char sep = 0;  // 0 = any whitespace
};

bool is_hex_like(const char* b, size_t n) {
  // strtod accepts C99 hex floats ('0x1A'); the Python reference parser
  // does not — reject so the Python parser reports such files
  for (size_t i = 0; i + 1 < n; ++i) {
    if ((b[i] == 'x' || b[i] == 'X')) return true;
  }
  return false;
}

bool is_nan_token(const char* b, size_t n) {
  if (n == 0) return true;
  static const char* toks[] = {"na", "nan", "NA", "NaN", "null"};
  for (const char* t : toks) {
    if (std::strlen(t) == n && std::strncmp(b, t, n) == 0) return true;
  }
  return false;
}

// count fields and parse one line into out (or just count when out==nullptr)
long parse_line(const ParsedFile& pf, size_t li, double* out, long max_cols) {
  const char* s = pf.data.data() + pf.lines[li].first;
  const char* e = pf.data.data() + pf.lines[li].second;
  // strip inline comment
  for (const char* p = s; p < e; ++p) {
    if (*p == '#') { e = p; break; }
  }
  long col = 0;
  const char* p = s;
  if (pf.sep == 0) {
    while (p < e) {
      while (p < e && std::isspace(static_cast<unsigned char>(*p))) ++p;
      if (p >= e) break;
      const char* tok = p;
      while (p < e && !std::isspace(static_cast<unsigned char>(*p))) ++p;
      if (out) {
        if (col >= max_cols) return -1;
        if (is_nan_token(tok, p - tok)) {
          out[col] = std::numeric_limits<double>::quiet_NaN();
        } else {
          char* endp = nullptr;
          double v = std::strtod(tok, &endp);
          // the token must be FULLY consumed and not a hex float: partial
          // or hex parses go to the Python parser, which reports them
          if (endp != p || is_hex_like(tok, p - tok)) return -2;
          out[col] = v;
        }
      }
      ++col;
    }
  } else {
    while (p <= e) {
      const char* tok = p;
      while (p < e && *p != pf.sep) ++p;
      // trim surrounding spaces
      const char* tb = tok;
      const char* te = p;
      while (tb < te && std::isspace(static_cast<unsigned char>(*tb))) ++tb;
      while (te > tb && std::isspace(static_cast<unsigned char>(te[-1]))) --te;
      if (out) {
        if (col >= max_cols) return -1;
        if (is_nan_token(tb, te - tb)) {
          out[col] = std::numeric_limits<double>::quiet_NaN();
        } else {
          char* endp = nullptr;
          double v = std::strtod(tb, &endp);
          if (endp != te || is_hex_like(tb, te - tb)) return -2;
          out[col] = v;
        }
      }
      ++col;
      if (p >= e) break;
      ++p;  // skip separator
    }
  }
  return col;
}

}  // namespace

extern "C" {

void* tp_open(const char* path, int has_header, int sep_char) {
  auto* pf = new ParsedFile();
  std::ifstream fh(path, std::ios::binary);
  if (!fh) { delete pf; return nullptr; }
  fh.seekg(0, std::ios::end);
  std::streamsize size = fh.tellg();
  fh.seekg(0);
  pf->data.resize(static_cast<size_t>(size));
  if (size > 0 && !fh.read(&pf->data[0], size)) { delete pf; return nullptr; }

  // line index (single pass; memchr-driven, IO dominates anyway)
  size_t begin = 0;
  const size_t n = pf->data.size();
  if (has_header) {
    // drop the FIRST PHYSICAL line unconditionally — identical to the
    // Python parser's lines[1:] (even if it is blank or a comment)
    const void* nl = std::memchr(pf->data.data(), '\n', n);
    begin = nl ? static_cast<const char*>(nl) - pf->data.data() + 1 : n;
  }
  while (begin < n) {
    const void* nl = std::memchr(pf->data.data() + begin, '\n', n - begin);
    size_t end = nl ? static_cast<const char*>(nl) - pf->data.data() : n;
    size_t te = end;
    if (te > begin && pf->data[te - 1] == '\r') --te;
    // skip blank / pure-comment lines
    size_t tb = begin;
    while (tb < te && std::isspace(static_cast<unsigned char>(pf->data[tb])))
      ++tb;
    if (tb < te && pf->data[tb] != '#') {
      pf->lines.emplace_back(begin, te);
    }
    begin = end + 1;
  }
  pf->rows = static_cast<long>(pf->lines.size());
  pf->sep = static_cast<char>(sep_char);
  pf->cols = pf->rows > 0 ? parse_line(*pf, 0, nullptr, 0) : 0;
  return pf;
}

long tp_rows(void* h) { return static_cast<ParsedFile*>(h)->rows; }
long tp_cols(void* h) { return static_cast<ParsedFile*>(h)->cols; }

// Fill a row-major rows*cols buffer. Returns 0 on success, the failing
// 1-based row number when a line has the wrong field count.
// max_threads <= 0 means auto (hardware concurrency).
long tp_fill(void* h, double* out, long max_threads) {
  auto* pf = static_cast<ParsedFile*>(h);
  const long rows = pf->rows, cols = pf->cols;
  unsigned hw = std::thread::hardware_concurrency();
  long cap = max_threads > 0 ? max_threads : static_cast<long>(hw ? hw : 1);
  long nthreads = std::max(1L, std::min<long>(cap, rows / 4096 + 1));
  std::vector<std::thread> threads;
  std::vector<long> bad(static_cast<size_t>(nthreads), 0);
  auto work = [&](long t) {
    long lo = rows * t / nthreads, hi = rows * (t + 1) / nthreads;
    for (long r = lo; r < hi; ++r) {
      long c = parse_line(*pf, static_cast<size_t>(r), out + r * cols, cols);
      if (c != cols) { bad[static_cast<size_t>(t)] = r + 1; return; }
    }
  };
  for (long t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  for (long b : bad) if (b) return b;
  return 0;
}

void tp_close(void* h) { delete static_cast<ParsedFile*>(h); }

}  // extern "C"

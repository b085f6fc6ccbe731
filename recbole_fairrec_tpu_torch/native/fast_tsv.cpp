// Fast single-pass atomic-file (headered TSV) reader.
//
// The reference parses atomic files with pandas.read_csv (python engine,
// recbole/data/dataset/dataset.py:438-440). This native reader does one
// mmap'd pass: float columns parse straight into double buffers, token
// columns are factorized on the fly (first-occurrence order, matching
// pandas.factorize) into int32 codes + a unique-token table.
//
// C ABI (driven from ctypes — see recbole_fairrec_tpu/data/fast_tsv.py):
//   tsv_open(path, sep, col_indices, col_is_token, n_cols) -> handle
//   tsv_n_rows(handle) -> rows parsed
//   tsv_error(handle) -> const char* ("" when ok)
//   tsv_float_col(handle, slot) -> const double*
//   tsv_token_codes(handle, slot) -> const int32_t*
//   tsv_token_uniques(handle, slot, &total_len) -> '\n'-joined const char*
//   tsv_close(handle)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct TokenCol {
  std::vector<int32_t> codes;
  std::vector<std::string> uniques;
  std::unordered_map<std::string, int32_t> lut;
  std::string joined;  // lazily built '\n'-joined uniques
};

struct FloatCol {
  std::vector<double> values;
};

struct Handle {
  std::string error;
  size_t n_rows = 0;
  // slot s corresponds to the s-th requested column
  std::vector<int> col_index;     // physical column in the file
  std::vector<int> is_token;      // 1 = token (factorized), 0 = float
  std::vector<TokenCol> tokens;   // slot-indexed (empty for float slots)
  std::vector<FloatCol> floats;   // slot-indexed (empty for token slots)
};

inline double parse_double(const char* s, size_t len) {
  if (len == 0) return NAN;
  char buf[64];
  size_t n = len < 63 ? len : 63;
  memcpy(buf, s, n);
  buf[n] = '\0';
  char* end = nullptr;
  double v = strtod(buf, &end);
  if (end == buf) return NAN;
  return v;
}

}  // namespace

extern "C" {

void* tsv_open(const char* path, char sep, const int* col_indices,
               const int* col_is_token, int n_cols) {
  auto* h = new Handle();
  h->col_index.assign(col_indices, col_indices + n_cols);
  h->is_token.assign(col_is_token, col_is_token + n_cols);
  h->tokens.resize(n_cols);
  h->floats.resize(n_cols);

  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    h->error = "cannot open file";
    return h;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    h->error = "cannot stat file or empty";
    close(fd);
    return h;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* data =
      static_cast<const char*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) {
    h->error = "mmap failed";
    return h;
  }

  int max_col = 0;
  for (int c : h->col_index) max_col = c > max_col ? c : max_col;

  // skip header line
  size_t pos = 0;
  while (pos < size && data[pos] != '\n') pos++;
  if (pos < size) pos++;

  // reserve with a row-count estimate
  size_t est_rows = size / 24 + 16;
  for (int s = 0; s < n_cols; s++) {
    if (h->is_token[s]) h->tokens[s].codes.reserve(est_rows);
    else h->floats[s].values.reserve(est_rows);
  }

  // slot lookup by physical column
  std::vector<int> slot_of(max_col + 1, -1);
  for (int s = 0; s < n_cols; s++) slot_of[h->col_index[s]] = s;

  std::vector<const char*> f_start(max_col + 1, nullptr);
  std::vector<size_t> f_len(max_col + 1, 0);

  std::string key;  // reused token buffer
  while (pos < size) {
    // parse one line into field spans up to max_col
    int col = 0;
    size_t field_start = pos;
    for (int c = 0; c <= max_col; c++) { f_start[c] = nullptr; f_len[c] = 0; }
    while (pos <= size) {
      char ch = (pos < size) ? data[pos] : '\n';
      if (ch == sep || ch == '\n' || ch == '\r') {
        if (col <= max_col) {
          f_start[col] = data + field_start;
          f_len[col] = pos - field_start;
        }
        col++;
        if (ch == '\r') {
          pos++;
          continue;  // swallow \r before \n
        }
        pos++;
        field_start = pos;
        if (ch == '\n') break;
      } else {
        pos++;
      }
      if (pos > size) break;
    }
    if (col == 1 && f_len[0] == 0) continue;  // blank line

    for (int s = 0; s < n_cols; s++) {
      int c = h->col_index[s];
      const char* fs = (c <= max_col) ? f_start[c] : nullptr;
      size_t fl = (c <= max_col) ? f_len[c] : 0;
      if (h->is_token[s]) {
        TokenCol& tc = h->tokens[s];
        if (fs == nullptr || fl == 0) {
          tc.codes.push_back(-1);  // missing -> NaN-like sentinel
        } else {
          key.assign(fs, fl);
          auto it = tc.lut.find(key);
          if (it == tc.lut.end()) {
            int32_t code = static_cast<int32_t>(tc.uniques.size());
            tc.lut.emplace(key, code);
            tc.uniques.push_back(key);
            tc.codes.push_back(code);
          } else {
            tc.codes.push_back(it->second);
          }
        }
      } else {
        h->floats[s].values.push_back(fs ? parse_double(fs, fl) : NAN);
      }
    }
    h->n_rows++;
  }

  munmap(const_cast<char*>(data), size);
  return h;
}

long long tsv_n_rows(void* handle) {
  return static_cast<long long>(static_cast<Handle*>(handle)->n_rows);
}

const char* tsv_error(void* handle) {
  return static_cast<Handle*>(handle)->error.c_str();
}

const double* tsv_float_col(void* handle, int slot) {
  return static_cast<Handle*>(handle)->floats[slot].values.data();
}

const int32_t* tsv_token_codes(void* handle, int slot) {
  return static_cast<Handle*>(handle)->tokens[slot].codes.data();
}

const char* tsv_token_uniques(void* handle, int slot, long long* total_len) {
  TokenCol& tc = static_cast<Handle*>(handle)->tokens[slot];
  if (tc.joined.empty() && !tc.uniques.empty()) {
    size_t total = 0;
    for (auto& u : tc.uniques) total += u.size() + 1;
    tc.joined.reserve(total);
    for (size_t i = 0; i < tc.uniques.size(); i++) {
      if (i) tc.joined.push_back('\n');
      tc.joined.append(tc.uniques[i]);
    }
  }
  *total_len = static_cast<long long>(tc.joined.size());
  return tc.joined.c_str();
}

long long tsv_token_n_uniques(void* handle, int slot) {
  return static_cast<long long>(
      static_cast<Handle*>(handle)->tokens[slot].uniques.size());
}

void tsv_close(void* handle) { delete static_cast<Handle*>(handle); }

}  // extern "C"

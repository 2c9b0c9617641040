// Native bulk loader: delimited text -> columnar buffers.
//
// Reference: the reference's bulk-import hot path is native-backed
// (Lightning local backend + mydump parsers, pkg/lightning/mydump); TiDB's
// LOAD DATA row path is pkg/executor/load_data.go. This is the tidb_tpu
// equivalent: one pass over the file, splitting fields and parsing
// numerics/dates/decimals directly into columnar arrays that Python wraps
// as numpy without copies (ctypes, see tidb_tpu_torch/storage/native.py; a copy of the JAX
// package's native/loader.cpp).
//
// Type codes: 0=int64, 1=float64, 2=string, 3=date(days since epoch),
// 4=decimal (scaled int64; scale passed per column), 5=bool.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Column {
  int type;
  int scale;
  std::vector<int64_t> i64;
  std::vector<double> f64;
  std::vector<uint8_t> valid;
  std::string str_bytes;
  std::vector<int64_t> str_offsets;  // nrows+1
};

struct ParseResult {
  int64_t nrows = 0;
  std::vector<Column> cols;
  std::string error;
};

// Howard Hinnant's civil date algorithm (branchless days-from-civil).
int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const int64_t yoe = y - era * 400;
  const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

bool parse_int(const char* s, const char* e, int64_t* out) {
  if (s == e) return false;
  bool neg = false;
  if (*s == '-' || *s == '+') { neg = *s == '-'; ++s; }
  if (s == e) return false;
  int64_t v = 0;
  for (; s != e; ++s) {
    if (*s < '0' || *s > '9') return false;
    v = v * 10 + (*s - '0');
  }
  *out = neg ? -v : v;
  return true;
}

bool parse_double(const char* s, const char* e, double* out) {
  char buf[64];
  size_t n = (size_t)(e - s);
  if (n == 0 || n >= sizeof(buf)) return false;
  memcpy(buf, s, n);
  buf[n] = 0;
  char* endp = nullptr;
  *out = strtod(buf, &endp);
  return endp == buf + n;
}

// decimal: parse as sign, integer part, fraction; scale to 10^scale.
bool parse_decimal(const char* s, const char* e, int scale, int64_t* out) {
  if (s == e) return false;
  bool neg = false;
  if (*s == '-' || *s == '+') { neg = *s == '-'; ++s; }
  int64_t ip = 0;
  while (s != e && *s != '.') {
    if (*s < '0' || *s > '9') return false;
    ip = ip * 10 + (*s - '0');
    ++s;
  }
  int64_t frac = 0;
  int fd = 0;
  if (s != e && *s == '.') {
    ++s;
    while (s != e && fd < scale) {
      if (*s < '0' || *s > '9') return false;
      frac = frac * 10 + (*s - '0');
      ++fd;
      ++s;
    }
    // round on the first truncated digit
    if (s != e && *s >= '5' && *s <= '9') ++frac;
    while (s != e) {
      if (*s < '0' || *s > '9') return false;
      ++s;
    }
  }
  for (; fd < scale; ++fd) frac *= 10;
  int64_t pow10 = 1;
  for (int i = 0; i < scale; ++i) pow10 *= 10;
  int64_t v = ip * pow10 + frac;
  *out = neg ? -v : v;
  return true;
}

bool parse_date(const char* s, const char* e, int64_t* out) {
  // yyyy-mm-dd
  if (e - s < 8) return false;
  int64_t y = 0, m = 0, d = 0;
  const char* p = s;
  while (p != e && *p != '-') {
    if (*p < '0' || *p > '9') return false;
    y = y * 10 + (*p - '0');
    ++p;
  }
  if (p == e) return false;
  ++p;
  while (p != e && *p != '-') {
    if (*p < '0' || *p > '9') return false;
    m = m * 10 + (*p - '0');
    ++p;
  }
  if (p == e) return false;
  ++p;
  while (p != e) {
    if (*p < '0' || *p > '9') return false;
    d = d * 10 + (*p - '0');
    ++p;
  }
  if (m < 1 || m > 12 || d < 1 || d > 31) return false;
  *out = days_from_civil(y, m, d);
  return true;
}

void append_field(Column& c, const char* s, const char* ee) {
  // trim \r
  const char* e = ee;
  while (e > s && (e[-1] == '\r')) --e;
  bool isnull = (s == e) || (e - s == 2 && s[0] == '\\' && s[1] == 'N');
  if (isnull) {
    c.valid.push_back(0);
    switch (c.type) {
      case 1: c.f64.push_back(0); break;
      case 2:
        c.str_offsets.push_back((int64_t)c.str_bytes.size());
        break;
      default: c.i64.push_back(0); break;
    }
    return;
  }
  bool ok = true;
  switch (c.type) {
    case 0: case 5: {
      int64_t v = 0;
      ok = parse_int(s, e, &v);
      if (!ok) { double dv; ok = parse_double(s, e, &dv); v = (int64_t)dv; }
      c.i64.push_back(ok ? v : 0);
      break;
    }
    case 1: {
      double v = 0;
      ok = parse_double(s, e, &v);
      c.f64.push_back(ok ? v : 0);
      break;
    }
    case 2: {
      c.str_bytes.append(s, (size_t)(e - s));
      c.str_offsets.push_back((int64_t)c.str_bytes.size());
      break;
    }
    case 3: {
      int64_t v = 0;
      ok = parse_date(s, e, &v);
      c.i64.push_back(ok ? v : 0);
      break;
    }
    case 4: {
      int64_t v = 0;
      ok = parse_decimal(s, e, c.scale, &v);
      c.i64.push_back(ok ? v : 0);
      break;
    }
  }
  c.valid.push_back(ok ? 1 : 0);
}

}  // namespace

extern "C" {

void* tt_parse_file(const char* path, char sep, int ncols,
                    const int* typecodes, const int* scales) {
  auto* res = new ParseResult();
  res->cols.resize((size_t)ncols);
  for (int i = 0; i < ncols; ++i) {
    res->cols[(size_t)i].type = typecodes[i];
    res->cols[(size_t)i].scale = scales[i];
    if (typecodes[i] == 2) res->cols[(size_t)i].str_offsets.push_back(0);
  }

  FILE* f = fopen(path, "rb");
  if (!f) {
    res->error = std::string("cannot open ") + path;
    return res;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data;
  data.resize((size_t)size);
  if (size > 0 && fread(&data[0], 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    res->error = "short read";
    return res;
  }
  fclose(f);

  const char* p = data.data();
  const char* end = p + data.size();
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    if (line_end > p) {  // skip empty lines
      const char* fs = p;
      int col = 0;
      const char* q = p;
      for (; q <= line_end && col < ncols; ++q) {
        if (q == line_end || *q == sep) {
          append_field(res->cols[(size_t)col], fs, q);
          ++col;
          fs = q + 1;
        }
      }
      if (col != ncols) {
        // tolerate dbgen trailing separator: already consumed ncols
        char buf[128];
        snprintf(buf, sizeof buf, "row %lld has %d fields, want %d",
                 (long long)res->nrows + 1, col, ncols);
        res->error = buf;
        return res;
      }
      res->nrows++;
    }
    p = line_end + 1;
  }
  return res;
}

const char* tt_error(void* h) {
  auto* r = (ParseResult*)h;
  return r->error.empty() ? nullptr : r->error.c_str();
}

int64_t tt_nrows(void* h) { return ((ParseResult*)h)->nrows; }

const int64_t* tt_col_i64(void* h, int col) {
  return ((ParseResult*)h)->cols[(size_t)col].i64.data();
}
const double* tt_col_f64(void* h, int col) {
  return ((ParseResult*)h)->cols[(size_t)col].f64.data();
}
const uint8_t* tt_col_valid(void* h, int col) {
  return ((ParseResult*)h)->cols[(size_t)col].valid.data();
}
const char* tt_col_strbytes(void* h, int col, int64_t* len) {
  auto& c = ((ParseResult*)h)->cols[(size_t)col];
  *len = (int64_t)c.str_bytes.size();
  return c.str_bytes.data();
}
const int64_t* tt_col_stroffsets(void* h, int col) {
  return ((ParseResult*)h)->cols[(size_t)col].str_offsets.data();
}
void tt_free(void* h) { delete (ParseResult*)h; }

}  // extern "C"

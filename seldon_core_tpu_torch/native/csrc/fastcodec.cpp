// fastcodec — the SeldonMessage JSON codec of the PyTorch package's data
// plane: a single-pass splitter that hands Python
//
//   * an "envelope": the original JSON with the numeric payload removed
//     (meta/status/names/binData/... byte spans copied verbatim, so exotic
//     metadata survives untouched), and
//   * the payload as a contiguous double buffer + shape,
//
// so the hot path never materialises Python lists, and a formatter that
// emits a numeric payload fragment whose every double reads back exactly.
// Anything the fast path cannot represent (ragged/mixed ndarray, non-numeric
// entries, invalid JSON) returns SM_UNSUPPORTED and the caller takes the
// pure-Python codec: behaviour, not speed, is the contract.
//
// The formatter writes NaN, Infinity and -Infinity as Python's json module
// does (the package's JSON lane writes those literals), never C's "nan" /
// "inf", which no JSON parser reads.
//
// Exposed as a C ABI for ctypes, and to CPython through
// fastcodec_pymod.cpp, which includes this file.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

namespace {

enum Status : int {
  SM_OK = 0,
  SM_UNSUPPORTED = 1,  // valid-ish JSON the fast path doesn't model
  SM_INVALID = 2,      // malformed JSON
};

enum Kind : int {
  KIND_NONE = 0,
  KIND_TENSOR = 1,
  KIND_NDARRAY = 2,
};

struct Parse {
  int status = SM_INVALID;
  int kind = KIND_NONE;
  std::string envelope;
  std::vector<double> values;
  std::vector<long long> shape;
  std::string error;
};

struct Scanner {
  const char* p;
  const char* end;

  explicit Scanner(const char* buf, size_t len) : p(buf), end(buf + len) {}

  bool eof() const { return p >= end; }

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool lit(char c) {
    ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }

  char peek() {
    ws();
    return p < end ? *p : '\0';
  }

  // Skip a JSON string (opening quote already consumed). False on error.
  bool skip_string_body() {
    while (p < end) {
      char c = *p++;
      if (c == '\\') { if (p < end) ++p; }
      else if (c == '"') return true;
    }
    return false;
  }

  // Parse a string into out (handles escapes). Quote not yet consumed.
  // had_escape (optional) reports whether any escape sequence appeared —
  // callers that re-emit the string verbatim must fall back in that case.
  bool parse_string(std::string& out, bool* had_escape = nullptr) {
    ws();
    if (p >= end || *p != '"') return false;
    ++p;
    out.clear();
    if (had_escape) *had_escape = false;
    while (p < end) {
      char c = *p++;
      if (c == '"') return true;
      if (c == '\\') {
        if (had_escape) *had_escape = true;
        if (p >= end) return false;
        char e = *p++;
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (end - p < 4) return false;
            // keep the escape verbatim; envelope copies are verbatim anyway
            out += "\\u";
            out.append(p, 4);
            p += 4;
            break;
          }
          default: return false;
        }
      } else {
        out += c;
      }
    }
    return false;
  }

  // Skip any JSON value; on success the span [start, p) covers it.
  bool skip_value() {
    ws();
    if (p >= end) return false;
    char c = *p;
    if (c == '"') { ++p; return skip_string_body(); }
    if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      int depth = 0;
      while (p < end) {
        char d = *p++;
        if (d == '"') { if (!skip_string_body()) return false; }
        else if (d == open) ++depth;
        else if (d == close) { if (--depth == 0) return true; }
      }
      return false;
    }
    // number / true / false / null
    const char* start = p;
    while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
           *p != '\t' && *p != '\n' && *p != '\r')
      ++p;
    return p > start;
  }

  // Fast double parse, STRICT JSON grammar (no leading +/., no "01", digits
  // required around '.') so the fast path never accepts text json.loads
  // rejects.  Falls back to strtod for long mantissas / extreme exponents.
  bool parse_number(double& out) {
    ws();
    const char* start = p;
    bool neg = false;
    if (p < end && *p == '-') { neg = true; ++p; }
    if (p >= end || *p < '0' || *p > '9') return false;  // int part mandatory
    if (*p == '0' && p + 1 < end && p[1] >= '0' && p[1] <= '9')
      return false;  // leading zeros are not JSON
    uint64_t mant = 0;
    int digits = 0, frac_digits = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
      if (digits < 18) { mant = mant * 10 + (uint64_t)(*p - '0'); ++digits; }
      else ++digits;  // overflow — strtod fallback below
      ++p; any = true;
    }
    if (p < end && *p == '.') {
      ++p;
      if (p >= end || *p < '0' || *p > '9') return false;  // "1." not JSON
      while (p < end && *p >= '0' && *p <= '9') {
        if (digits < 18) { mant = mant * 10 + (uint64_t)(*p - '0'); ++digits; ++frac_digits; }
        else { ++digits; ++frac_digits; }
        ++p; any = true;
      }
    }
    int exp10 = 0; bool has_exp = false;
    if (p < end && (*p == 'e' || *p == 'E')) {
      has_exp = true; ++p;
      bool eneg = false;
      if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
      int ev = 0; bool edig = false;
      while (p < end && *p >= '0' && *p <= '9') { ev = ev * 10 + (*p - '0'); ++p; edig = true; }
      if (!edig) return false;
      exp10 = eneg ? -ev : ev;
    }
    if (!any) return false;
    int net_exp = exp10 - frac_digits;
    if (digits <= 15 && net_exp >= -22 && net_exp <= 22) {
      static const double pow10[] = {1e0,1e1,1e2,1e3,1e4,1e5,1e6,1e7,1e8,1e9,1e10,
                                     1e11,1e12,1e13,1e14,1e15,1e16,1e17,1e18,1e19,
                                     1e20,1e21,1e22};
      double v = (double)mant;
      v = net_exp >= 0 ? v * pow10[net_exp] : v / pow10[-net_exp];
      out = neg ? -v : v;
      return true;
    }
    (void)has_exp;
    char* endp = nullptr;
    std::string tmp(start, p - start);  // ensure NUL-terminated
    out = strtod(tmp.c_str(), &endp);
    return endp && *endp == '\0';
  }
};

// Parse a (possibly nested) numeric JSON array into flat values + shape.
// Rectangularity enforced; any non-number leaf => unsupported.
static int parse_ndarray(Scanner& s, std::vector<double>& vals,
                         std::vector<long long>& shape,
                         std::vector<int>& etypes, int depth) {
  if (!s.lit('[')) return SM_INVALID;
  if (depth >= 16) return SM_UNSUPPORTED;
  if ((int)shape.size() <= depth) { shape.push_back(-1); etypes.push_back(0); }
  long long count = 0;
  if (s.peek() == ']') { s.lit(']'); /* empty dim */ }
  else {
    for (;;) {
      char c = s.peek();
      if (c == '[') {
        // every element at a given depth must be the same kind across ALL
        // branches (rectangularity) — numpy would build an object array
        if (etypes[depth] == 1) return SM_UNSUPPORTED;
        etypes[depth] = 2;
        int rc = parse_ndarray(s, vals, shape, etypes, depth + 1);
        if (rc != SM_OK) return rc;
      } else if ((c >= '0' && c <= '9') || c == '-' || c == '.') {
        if (etypes[depth] == 2) return SM_UNSUPPORTED;
        etypes[depth] = 1;
        double v;
        if (!s.parse_number(v)) return SM_UNSUPPORTED;  // NaN/Infinity etc.
        vals.push_back(v);
      } else {
        // bools/strings/objects/NaN/garbage: python fallback decides
        return SM_UNSUPPORTED;
      }
      ++count;
      char d = s.peek();
      if (d == ',') { s.lit(','); continue; }
      if (d == ']') { s.lit(']'); break; }
      return SM_INVALID;
    }
  }
  if (shape[depth] == -1) shape[depth] = count;
  else if (shape[depth] != count) return SM_UNSUPPORTED;  // ragged
  return SM_OK;
}

// Parse "tensor":{"shape":[...],"values":[...]} payload.
static int parse_tensor(Scanner& s, std::vector<double>& vals,
                        std::vector<long long>& shape) {
  if (!s.lit('{')) return SM_INVALID;
  bool saw_values = false;
  if (s.peek() == '}') { s.lit('}'); return saw_values ? SM_OK : SM_UNSUPPORTED; }
  for (;;) {
    std::string key;
    bool key_escaped = false;
    if (!s.parse_string(key, &key_escaped)) return SM_INVALID;
    if (key_escaped) return SM_UNSUPPORTED;
    if (!s.lit(':')) return SM_INVALID;
    if (key == "shape") {
      if (!s.lit('[')) return SM_INVALID;
      if (s.peek() == ']') s.lit(']');
      else for (;;) {
        double v;
        if (!s.parse_number(v)) return SM_INVALID;
        shape.push_back((long long)v);
        char d = s.peek();
        if (d == ',') { s.lit(','); continue; }
        if (d == ']') { s.lit(']'); break; }
        return SM_INVALID;
      }
    } else if (key == "values") {
      if (!s.lit('[')) return SM_INVALID;
      saw_values = true;
      if (s.peek() == ']') s.lit(']');
      else for (;;) {
        char c = s.peek();
        if (!((c >= '0' && c <= '9') || c == '-' || c == '+' || c == '.'))
          return SM_UNSUPPORTED;
        double v;
        if (!s.parse_number(v)) return SM_INVALID;
        vals.push_back(v);
        char d = s.peek();
        if (d == ',') { s.lit(','); continue; }
        if (d == ']') { s.lit(']'); break; }
        return SM_INVALID;
      }
    } else {
      return SM_UNSUPPORTED;  // unknown tensor member
    }
    char d = s.peek();
    if (d == ',') { s.lit(','); continue; }
    if (d == '}') { s.lit('}'); break; }
    return SM_INVALID;
  }
  return saw_values ? SM_OK : SM_UNSUPPORTED;
}

// Parse the "data" object: payload members (ndarray/tensor) are extracted,
// everything else ("names", future members) is copied verbatim into env.
static int parse_data(Scanner& s, Parse& out, std::string& env) {
  if (!s.lit('{')) return SM_INVALID;
  env += '{';
  bool first = true;
  if (s.peek() == '}') { s.lit('}'); env += '}'; return SM_OK; }
  for (;;) {
    std::string key;
    bool key_escaped = false;
    if (!s.parse_string(key, &key_escaped)) return SM_INVALID;
    if (key_escaped) return SM_UNSUPPORTED;  // keys are re-emitted raw
    if (!s.lit(':')) return SM_INVALID;
    if (key == "ndarray") {
      if (out.kind != KIND_NONE) return SM_UNSUPPORTED;  // duplicate oneof
      if (s.peek() != '[') return SM_UNSUPPORTED;        // e.g. null
      out.kind = KIND_NDARRAY;
      std::vector<int> etypes;
      int rc = parse_ndarray(s, out.values, out.shape, etypes, 0);
      if (rc != SM_OK) return rc;
      // a trailing empty dim means an empty array — normalise shape product
      long long prod = 1;
      for (long long d : out.shape) prod *= d;
      if (prod != (long long)out.values.size()) return SM_UNSUPPORTED;
    } else if (key == "tensor") {
      if (out.kind != KIND_NONE) return SM_UNSUPPORTED;
      if (s.peek() != '{') return SM_UNSUPPORTED;
      out.kind = KIND_TENSOR;
      int rc = parse_tensor(s, out.values, out.shape);
      if (rc != SM_OK) return rc;
      if (out.shape.empty())
        out.shape.push_back((long long)out.values.size());
      long long prod = 1;
      for (long long d : out.shape) prod *= d;
      if (prod != (long long)out.values.size()) return SM_UNSUPPORTED;
    } else {
      const char* vstart = s.p;
      s.ws();
      vstart = s.p;
      if (!s.skip_value()) return SM_INVALID;
      if (!first) env += ',';
      env += '"'; env += key; env += "\":";
      env.append(vstart, s.p - vstart);
      first = false;
      // fallthrough to separator handling
      char d = s.peek();
      if (d == ',') { s.lit(','); continue; }
      if (d == '}') { s.lit('}'); break; }
      return SM_INVALID;
    }
    char d = s.peek();
    if (d == ',') { s.lit(','); continue; }
    if (d == '}') { s.lit('}'); break; }
    return SM_INVALID;
  }
  env += '}';
  return SM_OK;
}

static int parse_message(const char* buf, size_t len, Parse& out) {
  Scanner s(buf, len);
  if (!s.lit('{')) return SM_INVALID;
  std::string& env = out.envelope;
  env.reserve(128);
  env += '{';
  bool first = true;
  std::string data_env;
  bool has_data = false;
  if (s.peek() == '}') { s.lit('}'); }
  else for (;;) {
    std::string key;
    bool key_escaped = false;
    if (!s.parse_string(key, &key_escaped)) return SM_INVALID;
    if (key_escaped) return SM_UNSUPPORTED;  // keys are re-emitted raw
    if (!s.lit(':')) return SM_INVALID;
    if (key == "data") {
      // any duplicate top-level "data" (object-then-null, double object)
      // would need json.loads last-wins semantics — decline to Python
      if (has_data) return SM_UNSUPPORTED;
      if (s.peek() != '{') {
        // "data": null — treat as absent, like protobuf JsonFormat
        const char* vstart = s.p;
        if (!s.skip_value()) return SM_INVALID;
        std::string v(vstart, s.p - vstart);
        if (v != "null") return SM_UNSUPPORTED;
      } else {
        has_data = true;
        int rc = parse_data(s, out, data_env);
        if (rc != SM_OK) return rc;
      }
    } else {
      s.ws();
      const char* vstart = s.p;
      if (!s.skip_value()) return SM_INVALID;
      if (!first) env += ',';
      env += '"'; env += key; env += "\":";
      env.append(vstart, s.p - vstart);
      first = false;
    }
    char d = s.peek();
    if (d == ',') { s.lit(','); continue; }
    if (d == '}') { s.lit('}'); break; }
    return SM_INVALID;
  }
  s.ws();
  if (!s.eof()) return SM_INVALID;  // trailing garbage
  if (has_data) {
    if (!first) env += ',';
    env += "\"data\":";
    env += data_env;
  }
  env += '}';
  return SM_OK;
}

// ---------------------------------------------------------------------------
// Formatting: shortest-roundtrip double -> JSON text.
// ---------------------------------------------------------------------------

static int format_double(double v, char* buf /* >= 32 bytes */) {
  if (v != v) {
    // python json.dumps spelling; a NaN's sign bit is not written
    memcpy(buf, "NaN", 3);
    return 3;
  }
  if (v == __builtin_inf() || v == -__builtin_inf()) {
    if (v > 0) { memcpy(buf, "Infinity", 8); return 8; }
    memcpy(buf, "-Infinity", 9);
    return 9;
  }
  if (v == 0.0 && 1.0 / v < 0) {
    // python json.dumps(-0.0) keeps the sign; the integral path would drop it
    memcpy(buf, "-0.0", 4);
    return 4;
  }
  if (v == (double)(long long)v && v > -1e15 && v < 1e15) {
    // integral fast path, python-json style "N.0"
    long long i = (long long)v;
    int n = snprintf(buf, 32, "%lld.0", i);
    return n;
  }
  // %.17g always round-trips a double exactly; we trade a few wire bytes
  // (vs shortest-repr) for a single snprintf instead of a verify loop
  return snprintf(buf, 32, "%.17g", v);
}

}  // namespace

extern "C" {

// Single-call parse: fills a caller-provided view so the common path costs
// two FFI crossings (parse_view + free) instead of five getter calls.
struct SMView {
  int32_t status;
  int32_t kind;
  int32_t ndim;
  int32_t _pad;
  long long nvalues;
  long long envelope_len;
  const char* envelope;
  const double* values;
  const long long* shape;
};

Parse* sm_parse_view(const char* buf, long long len, SMView* view) {
  Parse* p = new (std::nothrow) Parse();
  if (!p) { if (view) view->status = SM_INVALID; return nullptr; }
  p->status = (buf && len >= 0) ? parse_message(buf, (size_t)len, *p) : SM_INVALID;
  if (p->status != SM_OK) {
    p->envelope.clear();
    p->values.clear();
    p->shape.clear();
  }
  if (view) {
    view->status = p->status;
    view->kind = p->kind;
    view->ndim = (int32_t)p->shape.size();
    view->nvalues = (long long)p->values.size();
    view->envelope_len = (long long)p->envelope.size();
    view->envelope = p->envelope.data();
    view->values = p->values.data();
    view->shape = p->shape.data();
  }
  return p;
}

Parse* sm_parse(const char* buf, long long len) {
  Parse* p = new (std::nothrow) Parse();
  if (!p) return nullptr;
  if (!buf || len < 0) { p->status = SM_INVALID; return p; }
  p->status = parse_message(buf, (size_t)len, *p);
  if (p->status != SM_OK) {
    p->envelope.clear();
    p->values.clear();
    p->shape.clear();
  }
  return p;
}

int sm_status(Parse* p) { return p ? p->status : SM_INVALID; }

const char* sm_envelope(Parse* p, long long* len) {
  if (!p) { if (len) *len = 0; return nullptr; }
  if (len) *len = (long long)p->envelope.size();
  return p->envelope.data();
}

int sm_kind(Parse* p) { return p ? p->kind : KIND_NONE; }

const double* sm_values(Parse* p, long long* n) {
  if (!p) { if (n) *n = 0; return nullptr; }
  if (n) *n = (long long)p->values.size();
  return p->values.data();
}

const long long* sm_shape(Parse* p, int* ndim) {
  if (!p) { if (ndim) *ndim = 0; return nullptr; }
  if (ndim) *ndim = (int)p->shape.size();
  return p->shape.data();
}

void sm_free(Parse* p) { delete p; }

// Empty-array nesting: mirror numpy .tolist() — full nesting down to the
// first zero-length dim, which renders as [] (e.g. (2,0) -> [[],[]],
// (0,5) -> [], (2,3,0) -> [[[],[],[]],[[],[],[]]]).
static void emit_empty_ndarray(std::string& out, const long long* shape,
                               int first_zero_dim, int d) {
  out += '[';
  if (d < first_zero_dim) {
    for (long long i = 0; i < shape[d]; ++i) {
      if (i) out += ',';
      emit_empty_ndarray(out, shape, first_zero_dim, d + 1);
    }
  }
  out += ']';
}

// Format a payload fragment from a flat double buffer:
//   kind==KIND_TENSOR  -> "tensor":{"shape":[..],"values":[..]}
//   kind==KIND_NDARRAY -> "ndarray":[[..],..] nested per shape
// Returns a malloc'd buffer (caller frees with sm_buf_free), len in out_len.
char* sm_format(const double* vals, const long long* shape, int ndim,
                int kind, long long* out_len) {
  if (!vals || !shape || ndim <= 0 || out_len == nullptr) return nullptr;
  long long total = 1;
  for (int i = 0; i < ndim; ++i) {
    if (shape[i] < 0) return nullptr;
    total *= shape[i];
  }
  std::string out;
  out.reserve((size_t)total * 8 + 64);
  char nb[32];
  if (kind == KIND_TENSOR) {
    out += "\"tensor\":{\"shape\":[";
    for (int i = 0; i < ndim; ++i) {
      if (i) out += ',';
      int n = snprintf(nb, sizeof nb, "%lld", shape[i]);
      out.append(nb, n);
    }
    out += "],\"values\":[";
    for (long long i = 0; i < total; ++i) {
      if (i) out += ',';
      out.append(nb, format_double(vals[i], nb));
    }
    out += "]}";
  } else if (kind == KIND_NDARRAY) {
    // nested arrays; divisor stack gives the index period of each dim close
    std::vector<long long> period(ndim);  // elements per sub-array at dim d
    long long acc = 1;
    for (int d = ndim - 1; d >= 0; --d) { acc *= shape[d]; period[d] = acc; }
    if (total == 0) {
      out += "\"ndarray\":";
      int z = 0;
      while (z < ndim && shape[z] != 0) ++z;
      emit_empty_ndarray(out, shape, z, 0);
    } else {
      out += "\"ndarray\":";
      for (long long i = 0; i < total; ++i) {
        for (int d = 0; d < ndim; ++d)
          if (i % period[d] == 0) out += '[';
        out.append(nb, format_double(vals[i], nb));
        for (int d = ndim - 1; d >= 0; --d)
          if ((i + 1) % period[d] == 0) out += ']';
        if (i + 1 < total) out += ',';
      }
    }
  } else {
    return nullptr;
  }
  char* buf = (char*)malloc(out.size());
  if (!buf) return nullptr;
  memcpy(buf, out.data(), out.size());
  *out_len = (long long)out.size();
  return buf;
}

void sm_buf_free(char* p) { free(p); }

}  // extern "C"

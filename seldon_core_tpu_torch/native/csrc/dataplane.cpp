// Native data plane — C++ HTTP/1.1 and h2/gRPC termination plus request
// batching for the PyTorch package's serving engine.
//
// The engine's Python lanes (runtime/rest.py, runtime/grpcfast.py) spend
// interpreter time on every request.  This module moves the per-request
// path of the common predict out of Python:
//
//   IO thread (C++, no GIL): epoll loop -> HTTP/1.1 parse -> JSON numeric
//     parse (fastcodec.cpp) -> rows appended to a width-keyed batch ->
//     batch published when full / deadline / a dispatch slot is idle.
//   Python worker threads: dp_next_batch() blocks (GIL released) -> a
//     float64 view of the stacked rows -> one device dispatch (the graph's
//     kernels) and its readback -> dp_complete_batch(y).
//   Completing thread (C++, no GIL): per-request JSON responses composed
//     and handed to the IO thread for ordered, flow-controlled writes.
//
// Python's cost becomes one FFI round-trip per BATCH.  A request goes to
// the fast lane only when the composer writes the answer the Python lane
// would: a JSON body whose only members are "data" (a numeric ndarray or
// tensor of one or two dims and nothing else) and "meta" (absent, {} or
// {"puid": "<printable ASCII>"}), with no Seldon-Deadline-Ms,
// Seldon-Tenant, Seldon-Tier or traceparent header.  Everything else —
// feedback, admin GETs, form-encoded or binary-wire bodies, a request
// carrying its own names, tags or routing, strData/binData/jsonData,
// >2-D tensors, oversized row counts — is queued verbatim, with its
// head, to Python (dp_next_misc / dp_respond_misc) and served by the
// full-semantics engine routes, preserving wire behaviour exactly.
//
// Response ordering per connection is FIFO by arrival (pipelining-safe),
// matching runtime/rest.py; keepalive, Connection: close, 404/405/411/
// 413/501 handling match the same contract.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

// ---- fastcodec.cpp C ABI (compiled into the same shared object) -----------
extern "C" {
struct SMViewC {
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
void* sm_parse_view(const char* buf, long long len, SMViewC* view);
void sm_free(void* p);
char* sm_format(const double* vals, const long long* shape, int ndim,
                int kind, long long* out_len);
void sm_buf_free(char* p);
}

namespace {

constexpr int SM_OK = 0;
constexpr int KIND_TENSOR = 1;
constexpr int KIND_NDARRAY = 2;

constexpr size_t MAX_HEAD = 64 * 1024;
constexpr size_t MAX_BODY = 256u * 1024 * 1024;  // matches runtime/rest.py
constexpr int MAX_CONN_OUTSTANDING = 128;        // matches its backpressure
constexpr long long MAX_QUEUED_ROWS = 1 << 17;   // global 503 backstop

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

// latency buckets — MUST match utils/metrics.py _BUCKETS (seconds)
constexpr double kBuckets[14] = {0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                                 0.05,   0.1,   0.25,   0.5,   1.0,  2.5,
                                 5.0,    10.0};

struct Stats {
  std::atomic<long long> n2xx{0}, n4xx{0}, n5xx{0};
  std::atomic<long long> sum_us{0};
  std::atomic<long long> hist[15]{};  // 14 buckets + +Inf
  void observe_ok(double secs) {
    n2xx.fetch_add(1, std::memory_order_relaxed);
    sum_us.fetch_add((long long)(secs * 1e6), std::memory_order_relaxed);
    int b = 0;
    while (b < 14 && secs > kBuckets[b]) b++;
    hist[b].fetch_add(1, std::memory_order_relaxed);
  }
};

// base32 [a-z2-7] puid, visually identical to messages.py new_puid()
struct PuidGen {
  uint64_t s;
  explicit PuidGen(uint64_t seed) : s(seed | 1) {}
  void fill(char* out26) {
    static const char alpha[] = "abcdefghijklmnopqrstuvwxyz234567";
    uint64_t x = 0;
    int have = 0;
    for (int i = 0; i < 26; i++) {
      if (have < 5) {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;  // xorshift64
        x = s;
        have = 64;
      }
      out26[i] = alpha[x & 31];
      x >>= 5;
      have -= 5;
    }
  }
};

struct ReqInfo {
  int conn_id;
  uint32_t conn_gen;
  uint64_t seq;       // per-conn response order (HTTP/1.1 lane)
  int kind;           // KIND_TENSOR / KIND_NDARRAY / KIND_PROTO
  long long rows;
  bool close_c = false;  // request asked Connection: close
  bool h2 = false;       // gRPC lane: respond by stream, not by seq
  uint32_t stream = 0;   // h2 stream id
  std::string meta;   // HTTP lane: the client's puid ("" -> generate)
  std::string puid;   // gRPC lane: client puid ("" -> generate)
  double t0;          // parse time, for the latency histogram
};

constexpr int KIND_PROTO = 100;  // gRPC tensor request (proto wire response)

struct Batch {
  long long id;
  long long width;
  std::vector<double> data;  // rows * width, row-major
  std::vector<ReqInfo> reqs;
  double t_first;
};

struct MiscReq {
  long long id;
  int conn_id;
  uint32_t conn_gen;
  uint64_t seq;
  bool close_c = false;
  bool h2 = false;       // gRPC misc: method="GRPC", body = message bytes
  uint32_t stream = 0;
  std::string method;  // "GET" / "POST"
  std::string path;    // without query
  std::string query;
  std::string ctype;
  std::string body;
  std::string head;    // HTTP: the request head; gRPC: the metadata the
                       // Python lane binds, as "\r\nname: value" lines
};

struct H2State;  // defined in the gRPC lane section below

struct Conn {
  int fd = -1;
  uint32_t gen = 0;
  bool h2 = false;
  std::unique_ptr<H2State> h2s;
  std::string in;
  size_t scan_from = 0;
  ssize_t head_end = -1;
  long long clen = -1;
  bool head_parsed = false;
  std::string hmethod, hpath, hquery, hctype;
  bool hclose = false;
  uint64_t next_assign = 0;   // next seq to hand out
  uint64_t next_write = 0;    // next seq to be written
  std::map<uint64_t, std::string> done;  // seq -> full HTTP response
  uint64_t close_after = UINT64_MAX;     // write responses <= this, then close
  std::string out;
  size_t out_off = 0;
  bool want_write = false;
  bool paused = false;
};

struct Plane {
  int listen_fd = -1;
  int port = 0;
  int ep = -1;
  int evfd = -1;
  std::thread io_thread;
  std::atomic<bool> stop{false};

  long long max_batch;
  double max_wait_s;
  int depth;
  std::string names_frag;        // JSON: '"names":["a","b"],' or ""
  std::string proto_names_frag;  // proto: DefaultData.names fields wire bytes

  std::vector<std::unique_ptr<Conn>> conns;
  std::vector<int> free_conns;

  // batching state (guarded by mu)
  std::mutex mu;
  std::condition_variable cv_batch;
  std::condition_variable cv_misc;
  std::unordered_map<long long, std::unique_ptr<Batch>> accum;  // width -> batch
  std::deque<std::unique_ptr<Batch>> ready;
  std::unordered_map<long long, std::unique_ptr<Batch>> inflight;
  std::deque<std::unique_ptr<MiscReq>> misc_q;
  std::unordered_map<long long, std::unique_ptr<MiscReq>> misc_inflight;
  long long next_batch_id = 1;
  long long next_misc_id = 1;
  long long queued_rows = 0;
  int inflight_count = 0;

  // completions: responses composed off-thread, flushed by the IO thread
  struct Completion {
    int conn_id;
    uint32_t gen;
    bool h2;
    uint64_t seq;      // HTTP lane: response order slot
    uint32_t stream;   // gRPC lane: stream id
    int grpc_status;   // gRPC lane: 0 = data+OK trailers, else trailers-only
    std::string data;  // HTTP: full response; h2 ok: grpc message frame;
                       // h2 error: grpc-message text
  };
  std::mutex cmu;
  std::vector<Completion> completions;

  // gRPC listener (0 = lane disabled)
  int grpc_listen_fd = -1;
  int grpc_port = 0;

  // io-thread-local: conns needing a parse retry after backpressure resume
  std::vector<int> resume_parse;

  Stats stats;     // HTTP/1.1 fast lane
  Stats stats_h2;  // h2/gRPC fast lane — kept separate so /prometheus can
                   // attribute each surface to its own metric child
  PuidGen puid;

  Plane() : puid((uint64_t)now_s() * 1000003 ^ (uint64_t)(uintptr_t)this) {}
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

const char* status_text(int code) {
  switch (code) {
    case 200: return "OK";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 411: return "Length Required";
    case 413: return "Payload Too Large";
    case 500: return "Internal Server Error";
    case 501: return "Not Implemented";
    case 503: return "Service Unavailable";
    case 504: return "Gateway Timeout";
    default: return "X";
  }
}

std::string http_response(int code, const char* ctype, const char* body,
                          size_t body_len, bool close_conn) {
  char head[512];
  int n = snprintf(head, sizeof head,
                   "HTTP/1.1 %d %s\r\nContent-Length: %zu\r\n"
                   "Content-Type: %s\r\n%s\r\n",
                   code, status_text(code), body_len, ctype,
                   close_conn ? "Connection: close\r\n" : "");
  // snprintf returns the would-be length; clamp so an oversized
  // content-type truncates instead of reading past the buffer
  if (n < 0) n = 0;
  if ((size_t)n >= sizeof head) n = (int)sizeof head - 1;
  std::string out;
  out.reserve((size_t)n + body_len);
  out.append(head, (size_t)n);
  out.append(body, body_len);
  return out;
}

// The fast lane's envelope rule.  fastcodec writes the envelope as
// {<members, keys raw, values verbatim>,"data":{<non-payload members>}}:
// the lane takes {"data":{}} and {"meta":M,"data":{}} where M is {} or
// {"puid":"P"} (whitespace allowed) with P printable ASCII and no escape,
// and reports P ("" for none).  Anything else — names, tags, routing,
// status, strData, unknown members — is the Python lane's to answer.
bool fast_envelope(const char* env, long long len, std::string& puid) {
  static const char kTail[] = "\"data\":{}}";
  static const char kMeta[] = "{\"meta\":";
  const size_t tail = sizeof kTail - 1, mk = sizeof kMeta - 1;
  puid.clear();
  if (len < (long long)(tail + 1) ||
      memcmp(env + len - tail, kTail, tail) != 0)
    return false;
  size_t head = (size_t)len - tail;  // env[0, head) is "{" or "{"meta":M,"
  if (head == 1) return env[0] == '{';
  if (head < mk + 3 || memcmp(env, kMeta, mk) != 0 || env[head - 1] != ',')
    return false;
  const char* p = env + mk;
  const char* e = env + head - 1;
  auto ws = [&] { while (p < e && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p; };
  ws();
  if (p >= e || *p++ != '{') return false;
  ws();
  if (p < e && *p == '}') { ++p; ws(); return p == e; }
  static const char kPuid[] = "\"puid\"";
  if (e - p < 6 || memcmp(p, kPuid, 6) != 0) return false;
  p += 6;
  ws();
  if (p >= e || *p++ != ':') return false;
  ws();
  if (p >= e || *p++ != '"') return false;
  const char* s0 = p;
  while (p < e && *p != '"') {
    if (*p == '\\' || (unsigned char)*p < 0x20 || (unsigned char)*p >= 0x7f)
      return false;
    ++p;
  }
  if (p >= e || p == s0) return false;
  puid.assign(s0, p - s0);
  ++p;
  ws();
  if (p >= e || *p++ != '}') return false;
  ws();
  return p == e;
}

// the answer's meta: the client's puid, or a generated one
std::string response_meta(Plane* pl, const std::string& puid) {
  if (!puid.empty()) return "{\"puid\":\"" + puid + "\"}";
  char pbuf[26];
  pl->puid.fill(pbuf);
  return std::string("{\"puid\":\"") + std::string(pbuf, 26) + "\"}";
}

void queue_completion(Plane* pl, const ReqInfo& r, std::string&& resp) {
  {
    std::lock_guard<std::mutex> lk(pl->cmu);
    pl->completions.push_back(Plane::Completion{
        r.conn_id, r.conn_gen, false, r.seq, 0, 0, std::move(resp)});
  }
  uint64_t one = 1;
  (void)!write(pl->evfd, &one, 8);
}

void queue_completion_h2(Plane* pl, int conn_id, uint32_t gen,
                         uint32_t stream, int grpc_status,
                         std::string&& data) {
  {
    std::lock_guard<std::mutex> lk(pl->cmu);
    pl->completions.push_back(Plane::Completion{
        conn_id, gen, true, 0, stream, grpc_status, std::move(data)});
  }
  uint64_t one = 1;
  (void)!write(pl->evfd, &one, 8);
}

// ---------------------------------------------------------------------------
// IO thread
// ---------------------------------------------------------------------------

struct EvTag {  // epoll user data: fd class + conn index
  enum { LISTEN = -1, EVENT = -2, LISTEN_GRPC = -3 };
};

void arm(Plane* pl, int fd, int idx, uint32_t events, int op) {
  struct epoll_event ev;
  ev.events = events;
  ev.data.u64 = (uint64_t)(uint32_t)idx;
  epoll_ctl(pl->ep, op, fd, &ev);
}

void conn_close(Plane* pl, int ci) {
  Conn& c = *pl->conns[ci];
  if (c.fd < 0) return;
  epoll_ctl(pl->ep, EPOLL_CTL_DEL, c.fd, nullptr);
  close(c.fd);
  c.fd = -1;
  c.gen++;  // invalidates in-flight completions for this conn
  c.in.clear();
  c.in.shrink_to_fit();
  c.done.clear();
  c.out.clear();
  c.out.shrink_to_fit();
  pl->free_conns.push_back(ci);
}

// move ready ordered responses into the write buffer; write; manage EPOLLOUT.
// IO-thread only; never re-entered from the parse path (respond_now just
// queues — the caller flushes once parsing is done).
void conn_flush(Plane* pl, int ci) {
  Conn& c = *pl->conns[ci];
  if (c.fd < 0) return;
  // HTTP lane: responses drain strictly in request order; the h2 lane
  // writes frames straight into c.out (streams are self-identifying)
  while (!c.h2 && c.next_write <= c.close_after) {
    auto it = c.done.find(c.next_write);
    if (it == c.done.end()) break;
    c.out += it->second;
    c.done.erase(it);
    c.next_write++;
  }
  if (c.h2 && c.out.size() - c.out_off > 256u * 1024 * 1024) {
    // h2 write-side backstop: a client that pipelines requests but never
    // reads responses would grow c.out without bound (the HTTP lane's
    // MAX_CONN_OUTSTANDING pause covers this for HTTP/1.1)
    conn_close(pl, ci);
    return;
  }
  while (c.out_off < c.out.size()) {
    ssize_t n = write(c.fd, c.out.data() + c.out_off, c.out.size() - c.out_off);
    if (n > 0) { c.out_off += (size_t)n; continue; }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (!c.want_write) {
        c.want_write = true;
        arm(pl, c.fd, ci, EPOLLIN | EPOLLOUT, EPOLL_CTL_MOD);
      }
      return;
    }
    conn_close(pl, ci);
    return;
  }
  c.out.clear();
  c.out_off = 0;
  if (c.want_write) {
    c.want_write = false;
    arm(pl, c.fd, ci, EPOLLIN, EPOLL_CTL_MOD);
  }
  if (!c.h2 && c.next_write > c.close_after) {
    conn_close(pl, ci);
    return;
  }
  // resume reading when the pipeline drains; buffered-but-unparsed bytes
  // are retried by the io loop (no recursion into the parse path here)
  if (c.paused && c.next_assign - c.next_write <= MAX_CONN_OUTSTANDING / 2) {
    c.paused = false;
    arm(pl, c.fd, ci, c.want_write ? (EPOLLIN | EPOLLOUT) : EPOLLIN,
        EPOLL_CTL_MOD);
    pl->resume_parse.push_back(ci);
  }
}

// queue an immediate (parse-error / overload) response; the caller flushes
void respond_now(Plane* pl, int ci, int code, const char* body, bool close_c) {
  Conn& c = *pl->conns[ci];
  uint64_t seq = c.next_assign++;
  c.done[seq] = http_response(code, "text/plain", body, strlen(body), close_c);
  if (close_c) c.close_after = seq;
  if (code >= 500) pl->stats.n5xx.fetch_add(1, std::memory_order_relaxed);
  else if (code >= 400) pl->stats.n4xx.fetch_add(1, std::memory_order_relaxed);
}

void flush_batch_locked(Plane* pl, long long width) {
  // queued_rows keeps counting ready batches — they still occupy memory and
  // the 503 backstop must see them; dp_next_batch decrements on hand-off
  auto it = pl->accum.find(width);
  if (it == pl->accum.end() || !it->second) return;
  std::unique_ptr<Batch> b = std::move(it->second);
  pl->accum.erase(it);
  pl->ready.push_back(std::move(b));
  pl->cv_batch.notify_one();
}

// Shared batch admission for both lanes: append `rows x width` doubles and
// the request's ReqInfo to the width-keyed accumulation, flushing on
// overflow/full.  Returns false when the global row backstop is hit (the
// caller answers 503 / RESOURCE_EXHAUSTED).
bool enqueue_rows(Plane* pl, ReqInfo&& r, const void* vals, long long rows,
                  long long width) {
  std::lock_guard<std::mutex> lk(pl->mu);
  if (pl->queued_rows + rows > MAX_QUEUED_ROWS) return false;
  {
    auto pre = pl->accum.find(width);
    if (pre != pl->accum.end() && pre->second &&
        (long long)(pre->second->data.size() / width) + rows > pl->max_batch)
      flush_batch_locked(pl, width);  // this request would overflow: flush
  }
  auto& slot = pl->accum[width];
  if (!slot) {
    slot.reset(new Batch());
    slot->id = pl->next_batch_id++;
    slot->width = width;
    slot->data.reserve((size_t)std::min<long long>(pl->max_batch, 4096) *
                       width);
    slot->t_first = now_s();
  }
  Batch& b = *slot;
  size_t off = b.data.size();
  b.data.resize(off + (size_t)(rows * width));
  memcpy(b.data.data() + off, vals, sizeof(double) * (size_t)(rows * width));
  b.reqs.push_back(std::move(r));
  pl->queued_rows += rows;
  if ((long long)(b.data.size() / width) >= pl->max_batch)
    flush_batch_locked(pl, width);
  return true;
}

// returns false if the request was NOT eligible for the fast lane
bool try_fast_predict(Plane* pl, int ci, const char* body, size_t blen,
                      bool close_c) {
  Conn& c = *pl->conns[ci];
  SMViewC v;
  void* p = sm_parse_view(body, (long long)blen, &v);
  bool ok = p && v.status == SM_OK &&
            (v.kind == KIND_TENSOR || v.kind == KIND_NDARRAY) &&
            v.ndim >= 1 && v.ndim <= 2 && v.nvalues > 0;
  long long rows = 0, width = 0;
  if (ok) {
    rows = v.ndim == 2 ? v.shape[0] : 1;
    width = v.ndim == 2 ? v.shape[1] : v.nvalues;
    ok = rows > 0 && width > 0 && rows <= pl->max_batch;
  }
  std::string meta;
  // binData/strData/jsonData arrive with kind NONE (not ok); names, tags
  // and every other member fail the envelope rule
  if (ok) ok = fast_envelope(v.envelope, v.envelope_len, meta);
  if (!ok) {
    if (p) sm_free(p);
    return false;
  }
  ReqInfo r;
  r.conn_id = ci;
  r.conn_gen = c.gen;
  r.seq = c.next_assign++;
  r.kind = v.kind;
  r.rows = rows;
  r.close_c = close_c;
  r.meta = std::move(meta);
  r.t0 = now_s();
  uint64_t seq = r.seq;
  bool accepted = enqueue_rows(pl, std::move(r), v.values, rows, width);
  sm_free(p);
  if (!accepted) {
    // seq was already assigned: answer it, keeping per-conn order intact
    static const std::string overload =
        "{\"status\":{\"code\":503,\"status\":\"FAILURE\","
        "\"reason\":\"overloaded\"}}";
    Conn& cc = *pl->conns[ci];
    cc.done[seq] = http_response(503, "application/json", overload.data(),
                                 overload.size(), close_c);
    if (close_c) cc.close_after = seq;
    pl->stats.n5xx.fetch_add(1, std::memory_order_relaxed);
  }
  return true;
}

void to_misc(Plane* pl, int ci, bool close_c, std::string&& method,
             std::string&& path, std::string&& query, std::string&& ctype,
             std::string&& body, std::string&& head) {
  Conn& c = *pl->conns[ci];
  auto m = std::make_unique<MiscReq>();
  m->conn_id = ci;
  m->conn_gen = c.gen;
  m->seq = c.next_assign++;
  m->close_c = close_c;
  m->method = std::move(method);
  m->path = std::move(path);
  m->query = std::move(query);
  m->ctype = std::move(ctype);
  m->body = std::move(body);
  m->head = std::move(head);
  std::lock_guard<std::mutex> lk(pl->mu);
  m->id = pl->next_misc_id++;
  pl->misc_q.push_back(std::move(m));
  pl->cv_misc.notify_one();
}

// case-insensitive header value inside [head, head+len), name lower-case
// with colon; anchored at line start
std::string header_value(const char* head, size_t len, const char* name) {
  size_t nlen = strlen(name);
  for (size_t i = 0; i + 2 + nlen <= len; i++) {
    if (head[i] != '\r' || head[i + 1] != '\n') continue;
    size_t j = 0;
    while (j < nlen && i + 2 + j < len &&
           (char)(head[i + 2 + j] | 0x20) == name[j])
      j++;
    if (j == nlen) {
      size_t s = i + 2 + nlen;
      size_t e = s;
      while (e < len && head[e] != '\r') e++;
      while (s < e && head[s] == ' ') s++;
      while (e > s && head[e - 1] == ' ') e--;
      return std::string(head + s, e - s);
    }
  }
  return "";
}

void handle_request(Plane* pl, int ci, const char* head, size_t head_len,
                    const char* body, size_t body_len) {
  Conn& c = *pl->conns[ci];
  // request line
  const char* line_end = (const char*)memchr(head, '\r', head_len);
  size_t ll = line_end ? (size_t)(line_end - head) : head_len;
  std::string method, target;
  {
    const char* sp1 = (const char*)memchr(head, ' ', ll);
    if (!sp1) { respond_now(pl, ci, 400, "malformed request line", true); return; }
    const char* sp2 = (const char*)memchr(sp1 + 1, ' ', ll - (sp1 + 1 - head));
    if (!sp2) { respond_now(pl, ci, 400, "malformed request line", true); return; }
    method.assign(head, sp1 - head);
    target.assign(sp1 + 1, sp2 - sp1 - 1);
  }
  std::string conn_hdr = header_value(head, head_len, "connection:");
  bool close_c = conn_hdr.find("close") != std::string::npos;
  std::string path = target, query;
  size_t qp = target.find('?');
  if (qp != std::string::npos) {
    path = target.substr(0, qp);
    query = target.substr(qp + 1);
  }
  std::string ctype = header_value(head, head_len, "content-type:");

  // a header that the Python lane binds (a deadline, a QoS identity, a
  // trace parent) or a binary-wire body takes the misc lane
  if (method == "POST" && path == "/api/v0.1/predictions" &&
      ctype.find("form") == std::string::npos &&
      ctype.find("application/x-seldon-tensor") == std::string::npos &&
      header_value(head, head_len, "seldon-deadline-ms:").empty() &&
      header_value(head, head_len, "seldon-tenant:").empty() &&
      header_value(head, head_len, "seldon-tier:").empty() &&
      header_value(head, head_len, "traceparent:").empty()) {
    if (try_fast_predict(pl, ci, body, body_len, close_c)) {
      if (close_c) c.close_after = c.next_assign - 1;
      goto backpressure;
    }
  }
  // every other request, any method (the Python lane's table decides
  // 404 / 405, and /api/v0.1/events answers every method)
  to_misc(pl, ci, close_c, std::move(method), std::move(path),
          std::move(query), std::move(ctype), std::string(body, body_len),
          std::string(head, head_len));
  if (close_c) c.close_after = c.next_assign - 1;

backpressure:
  if (!c.paused && c.next_assign - c.next_write > MAX_CONN_OUTSTANDING) {
    c.paused = true;
    if (c.fd >= 0)
      arm(pl, c.fd, ci, c.want_write ? EPOLLOUT : 0, EPOLL_CTL_MOD);
  }
}

void conn_parse(Plane* pl, int ci) {
  Conn& c = *pl->conns[ci];
  size_t consumed = 0;
  while (c.fd >= 0 && !c.paused) {
    if (c.head_parsed) {
      if (c.in.size() - consumed < (size_t)c.head_end + (size_t)c.clen) break;
      size_t bstart = consumed + (size_t)c.head_end;
      handle_request(pl, ci, c.in.data() + consumed, (size_t)c.head_end,
                     c.in.data() + bstart, (size_t)c.clen);
      consumed = bstart + (size_t)c.clen;
      c.head_parsed = false;
      c.head_end = -1;
      c.clen = -1;
      c.scan_from = 0;
      continue;
    }
    // scan for end of headers
    size_t from = consumed + (c.scan_from > 3 ? c.scan_from - 3 : 0);
    const char* found = nullptr;
    if (c.in.size() > from + 3) {
      for (size_t i = from; i + 4 <= c.in.size(); i++) {
        if (c.in[i] == '\r' && c.in[i + 1] == '\n' && c.in[i + 2] == '\r' &&
            c.in[i + 3] == '\n') {
          found = c.in.data() + i;
          break;
        }
      }
    }
    if (!found) {
      if (c.in.size() - consumed > MAX_HEAD) {
        respond_now(pl, ci, 413, "headers too large", true);
        break;
      }
      c.scan_from = c.in.size() - consumed;
      break;
    }
    size_t head_len = (size_t)(found - (c.in.data() + consumed)) + 4;
    const char* head = c.in.data() + consumed;
    // RFC 7230: Transfer-Encoding wins over Content-Length (smuggling guard)
    if (!header_value(head, head_len, "transfer-encoding:").empty()) {
      respond_now(pl, ci, 501, "chunked bodies not supported", true);
      break;
    }
    long long clen = 0;
    std::string clv = header_value(head, head_len, "content-length:");
    if (!clv.empty()) {
      for (char ch : clv) {
        if (ch < '0' || ch > '9') { clen = -1; break; }
        clen = clen * 10 + (ch - '0');
        if (clen > (long long)MAX_BODY) break;
      }
      if (clen < 0) {
        respond_now(pl, ci, 400, "bad content-length", true);
        break;
      }
      if (clen > (long long)MAX_BODY) {
        respond_now(pl, ci, 413, "body too large", true);
        break;
      }
    }
    c.head_end = (ssize_t)head_len;
    c.clen = clen;
    c.head_parsed = true;
  }
  if (consumed) {
    c.in.erase(0, consumed);
    if (!c.head_parsed) c.scan_from = 0;
  }
}

void h2_parse(Plane* pl, int ci);  // gRPC lane, defined below

void conn_data(Plane* pl, int ci) {
  Conn& c = *pl->conns[ci];
  char buf[65536];
  for (;;) {
    if (c.fd < 0) return;
    ssize_t r = read(c.fd, buf, sizeof buf);
    if (r > 0) {
      c.in.append(buf, (size_t)r);
      if ((size_t)r == sizeof buf && !c.paused) continue;
    } else if (r == 0) {
      conn_close(pl, ci);
      return;
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      // no more data
    } else {
      conn_close(pl, ci);
      return;
    }
    break;
  }
  if (c.h2) h2_parse(pl, ci);
  else conn_parse(pl, ci);
}

// ---------------------------------------------------------------------------
// gRPC lane: HTTP/2 + HPACK + protobuf tensor fast path.
//
// The HPACK decoder is a C++ port of this package's own
// native/hpackcodec.py (RFC 7541: static+dynamic tables,
// Huffman via a bit trie built from the spec table); the proto scanner
// mirrors native/protowire.py exactly — any message shape
// the Python fast lane declines, this lane declines to the misc queue, so
// wire semantics never diverge between planes.
// ---------------------------------------------------------------------------

// RFC 7541 Appendix B Huffman code table (public spec data)
const uint32_t kHuffCodes[257] = {
    8184, 8388568, 268435426, 268435427, 268435428, 268435429, 268435430,
    268435431, 268435432, 16777194, 1073741820, 268435433, 268435434,
    1073741821, 268435435, 268435436, 268435437, 268435438, 268435439,
    268435440, 268435441, 268435442, 1073741822, 268435443, 268435444,
    268435445, 268435446, 268435447, 268435448, 268435449, 268435450,
    268435451, 20, 1016, 1017, 4090, 8185, 21, 248, 2042, 1018, 1019, 249,
    2043, 250, 22, 23, 24, 0, 1, 2, 25, 26, 27, 28, 29, 30, 31, 92, 251,
    32764, 32, 4091, 1020, 8186, 33, 93, 94, 95, 96, 97, 98, 99, 100, 101,
    102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112, 113, 114, 252,
    115, 253, 8187, 524272, 8188, 16380, 34, 32765, 3, 35, 4, 36, 5, 37, 38,
    39, 6, 116, 117, 40, 41, 42, 7, 43, 118, 44, 8, 9, 45, 119, 120, 121,
    122, 123, 32766, 2044, 16381, 8189, 268435452, 1048550, 4194258, 1048551,
    1048552, 4194259, 4194260, 4194261, 8388569, 4194262, 8388570, 8388571,
    8388572, 8388573, 8388574, 16777195, 8388575, 16777196, 16777197,
    4194263, 8388576, 16777198, 8388577, 8388578, 8388579, 8388580, 2097116,
    4194264, 8388581, 4194265, 8388582, 8388583, 16777199, 4194266, 2097117,
    1048553, 4194267, 4194268, 8388584, 8388585, 2097118, 8388586, 4194269,
    4194270, 16777200, 2097119, 4194271, 8388587, 8388588, 2097120, 2097121,
    4194272, 2097122, 8388589, 4194273, 8388590, 8388591, 1048554, 4194274,
    4194275, 4194276, 8388592, 4194277, 4194278, 8388593, 67108832, 67108833,
    1048555, 524273, 4194279, 8388594, 4194280, 33554412, 67108834, 67108835,
    67108836, 134217694, 134217695, 67108837, 16777201, 33554413, 524274,
    2097123, 67108838, 134217696, 134217697, 67108839, 134217698, 16777202,
    2097124, 2097125, 67108840, 67108841, 268435453, 134217699, 134217700,
    134217701, 1048556, 16777203, 1048557, 2097126, 4194281, 2097127,
    2097128, 8388595, 4194282, 4194283, 33554414, 33554415, 16777204,
    16777205, 67108842, 8388596, 67108843, 134217702, 67108844, 67108845,
    134217703, 134217704, 134217705, 134217706, 134217707, 268435454,
    134217708, 134217709, 134217710, 134217711, 134217712, 67108846,
    1073741823};
const uint8_t kHuffLens[257] = {
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28, 28, 28,
    28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28, 6,  10, 10, 12,
    13, 6,  8,  11, 10, 10, 8,  11, 8,  6,  6,  6,  5,  5,  5,  6,  6,  6,
    6,  6,  6,  6,  7,  8,  15, 6,  12, 10, 13, 6,  7,  7,  7,  7,  7,  7,
    7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  8,  7,
    8,  13, 19, 13, 14, 6,  15, 5,  6,  5,  6,  5,  6,  6,  6,  5,  7,  7,
    6,  6,  6,  5,  6,  7,  6,  5,  5,  6,  7,  7,  7,  7,  7,  15, 11, 14,
    13, 28, 20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24, 22, 21,
    20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23, 21, 21, 22, 21,
    23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23, 26, 26, 20, 19, 22, 23,
    22, 25, 26, 26, 26, 27, 27, 26, 24, 25, 19, 21, 26, 27, 27, 26, 27, 24,
    21, 21, 26, 26, 28, 27, 27, 27, 20, 24, 20, 21, 22, 21, 21, 23, 22, 22,
    25, 25, 24, 24, 26, 23, 26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27,
    27, 27, 27, 26, 30};

// Huffman decode trie: node pairs [zero_child, one_child], symbol per node.
struct HuffTrie {
  std::vector<int32_t> child;  // 2 per node, -1 = none
  std::vector<int16_t> sym;    // -1 = internal, 256 = EOS
  std::vector<bool> accept;    // all-ones-path states (legal padding ends)
  HuffTrie() {
    child.assign(2, -1);
    sym.assign(1, -1);
    for (int s = 0; s <= 256; s++) {
      uint32_t code = kHuffCodes[s];
      int len = kHuffLens[s];
      int n = 0;
      for (int i = len - 1; i >= 0; i--) {
        int bit = (code >> i) & 1;
        if (child[n * 2 + bit] < 0) {
          child[n * 2 + bit] = (int32_t)sym.size();
          child.push_back(-1);
          child.push_back(-1);
          sym.push_back(-1);
        }
        n = child[n * 2 + bit];
      }
      sym[n] = (int16_t)s;
    }
    accept.assign(sym.size(), false);
    accept[0] = true;
    int n = 0;
    for (;;) {
      n = child[n * 2 + 1];
      if (n < 0 || sym[n] >= 0) break;
      accept[n] = true;
    }
  }
};
const HuffTrie& huff_trie() {
  static HuffTrie t;
  return t;
}

bool huffman_decode(const uint8_t* data, size_t len, std::string& out) {
  const HuffTrie& t = huff_trie();
  int n = 0;
  for (size_t i = 0; i < len; i++) {
    for (int b = 7; b >= 0; b--) {
      int bit = (data[i] >> b) & 1;
      n = t.child[n * 2 + bit];
      if (n < 0) return false;
      int s = t.sym[n];
      if (s >= 0) {
        if (s == 256) return false;  // EOS in the body is an error
        out += (char)s;
        n = 0;
      }
    }
  }
  return t.accept[n];
}

struct HeaderPair {
  std::string name, value;
};

const HeaderPair kStaticTable[61] = {
    {":authority", ""}, {":method", "GET"}, {":method", "POST"},
    {":path", "/"}, {":path", "/index.html"}, {":scheme", "http"},
    {":scheme", "https"}, {":status", "200"}, {":status", "204"},
    {":status", "206"}, {":status", "304"}, {":status", "400"},
    {":status", "404"}, {":status", "500"}, {"accept-charset", ""},
    {"accept-encoding", "gzip, deflate"}, {"accept-language", ""},
    {"accept-ranges", ""}, {"accept", ""},
    {"access-control-allow-origin", ""}, {"age", ""}, {"allow", ""},
    {"authorization", ""}, {"cache-control", ""}, {"content-disposition", ""},
    {"content-encoding", ""}, {"content-language", ""}, {"content-length", ""},
    {"content-location", ""}, {"content-range", ""}, {"content-type", ""},
    {"cookie", ""}, {"date", ""}, {"etag", ""}, {"expect", ""},
    {"expires", ""}, {"from", ""}, {"host", ""}, {"if-match", ""},
    {"if-modified-since", ""}, {"if-none-match", ""}, {"if-range", ""},
    {"if-unmodified-since", ""}, {"last-modified", ""}, {"link", ""},
    {"location", ""}, {"max-forwards", ""}, {"proxy-authenticate", ""},
    {"proxy-authorization", ""}, {"range", ""}, {"referer", ""},
    {"refresh", ""}, {"retry-after", ""}, {"server", ""}, {"set-cookie", ""},
    {"strict-transport-security", ""}, {"transfer-encoding", ""},
    {"user-agent", ""}, {"vary", ""}, {"via", ""}, {"www-authenticate", ""}};

class HpackDec {
 public:
  explicit HpackDec(size_t max_table = 4096) : max_size_(max_table) {}

  // decode one header block; false on malformed (connection error)
  bool decode(const uint8_t* p, size_t len,
              std::vector<HeaderPair>& out) {
    size_t pos = 0;
    while (pos < len) {
      uint8_t b = p[pos];
      if (b & 0x80) {  // indexed
        uint64_t idx;
        if (!dec_int(p, len, pos, 7, idx) || idx == 0) return false;
        HeaderPair hp;
        if (!entry(idx, hp)) return false;
        out.push_back(std::move(hp));
      } else if ((b & 0xC0) == 0x40) {  // literal, incremental indexing
        uint64_t idx;
        if (!dec_int(p, len, pos, 6, idx)) return false;
        HeaderPair hp;
        if (!literal(p, len, pos, idx, hp)) return false;
        insert(hp);
        out.push_back(std::move(hp));
      } else if ((b & 0xE0) == 0x20) {  // dynamic table size update
        uint64_t sz;
        if (!dec_int(p, len, pos, 5, sz)) return false;
        if (sz > max_size_limit_) return false;
        max_size_ = (size_t)sz;
        evict();
      } else {  // literal without indexing / never indexed (4-bit prefix)
        uint64_t idx;
        if (!dec_int(p, len, pos, 4, idx)) return false;
        HeaderPair hp;
        if (!literal(p, len, pos, idx, hp)) return false;
        out.push_back(std::move(hp));
      }
    }
    return true;
  }

 private:
  std::deque<HeaderPair> dyn_;
  size_t dyn_size_ = 0;
  size_t max_size_;
  size_t max_size_limit_ = 4096;

  bool entry(uint64_t idx, HeaderPair& out) {
    if (idx >= 1 && idx <= 61) {
      out = kStaticTable[idx - 1];
      return true;
    }
    size_t d = (size_t)idx - 62;
    if (d >= dyn_.size()) return false;
    out = dyn_[d];
    return true;
  }

  void insert(const HeaderPair& hp) {
    size_t sz = hp.name.size() + hp.value.size() + 32;
    dyn_.push_front(hp);
    dyn_size_ += sz;
    evict();
  }

  void evict() {
    while (dyn_size_ > max_size_ && !dyn_.empty()) {
      dyn_size_ -= dyn_.back().name.size() + dyn_.back().value.size() + 32;
      dyn_.pop_back();
    }
  }

  static bool dec_int(const uint8_t* p, size_t len, size_t& pos, int prefix,
                      uint64_t& out) {
    if (pos >= len) return false;
    uint64_t mask = (1u << prefix) - 1;
    out = p[pos++] & mask;
    if (out < mask) return true;
    int shift = 0;
    for (;;) {
      if (pos >= len || shift > 35) return false;
      uint8_t b = p[pos++];
      out += (uint64_t)(b & 0x7F) << shift;
      shift += 7;
      if (!(b & 0x80)) return true;
    }
  }

  static bool dec_str(const uint8_t* p, size_t len, size_t& pos,
                      std::string& out) {
    if (pos >= len) return false;
    bool huff = p[pos] & 0x80;
    uint64_t n;
    if (!dec_int(p, len, pos, 7, n)) return false;
    if (pos + n > len) return false;
    if (huff) {
      if (!huffman_decode(p + pos, (size_t)n, out)) return false;
    } else {
      out.assign((const char*)p + pos, (size_t)n);
    }
    pos += (size_t)n;
    return true;
  }

  bool literal(const uint8_t* p, size_t len, size_t& pos, uint64_t name_idx,
               HeaderPair& out) {
    if (name_idx) {
      HeaderPair nm;
      if (!entry(name_idx, nm)) return false;
      out.name = std::move(nm.name);
    } else if (!dec_str(p, len, pos, out.name)) {
      return false;
    }
    return dec_str(p, len, pos, out.value);
  }
};

// --- protobuf tensor scan (mirrors native/protowire.py exactly) ------------

bool pw_varint(const uint8_t* p, size_t len, size_t& pos, uint64_t& out) {
  out = 0;
  int shift = 0;
  while (pos < len) {
    uint8_t b = p[pos++];
    out |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

bool pw_skip(const uint8_t* p, size_t len, size_t& pos, int wt) {
  uint64_t n;
  switch (wt) {
    case 0: return pw_varint(p, len, pos, n);
    case 1: pos += 8; return pos <= len;
    case 2:
      if (!pw_varint(p, len, pos, n) || pos + n > len) return false;
      pos += (size_t)n;
      return true;
    case 5: pos += 4; return pos <= len;
    default: return false;
  }
}

// SeldonMessage{meta{puid only}, data{names*, tensor{shape packed, values
// packed}}} -> rows/width/values-span/puid; anything else declines (misc
// lane = full protobuf semantics), exactly like protowire.parse_tensor_request
struct PwTensor {
  const uint8_t* values = nullptr;
  long long nvalues = 0;
  std::vector<long long> shape;
  std::string puid;
};

bool pw_scan_meta(const uint8_t* p, size_t len, std::string& puid) {
  size_t pos = 0;
  while (pos < len) {
    uint64_t key;
    if (!pw_varint(p, len, pos, key)) return false;
    if ((key >> 3) == 1 && (key & 7) == 2) {
      uint64_t n;
      if (!pw_varint(p, len, pos, n) || pos + n > len) return false;
      puid.assign((const char*)p + pos, (size_t)n);
      pos += (size_t)n;
    } else {
      return false;  // tags/routing/requestPath present -> full parser
    }
  }
  return true;
}

bool pw_scan_tensor(const uint8_t* p, size_t len, PwTensor& t) {
  size_t pos = 0;
  bool have_values = false;
  while (pos < len) {
    uint64_t key;
    if (!pw_varint(p, len, pos, key)) return false;
    int field = (int)(key >> 3), wt = (int)(key & 7);
    if (field == 1) {  // shape, packed (or repeated varint)
      if (wt == 2) {
        uint64_t n;
        if (!pw_varint(p, len, pos, n) || pos + n > len) return false;
        size_t sub_end = pos + (size_t)n;
        while (pos < sub_end) {
          uint64_t d;
          if (!pw_varint(p, sub_end, pos, d)) return false;
          t.shape.push_back((long long)d);
        }
      } else if (wt == 0) {
        uint64_t d;
        if (!pw_varint(p, len, pos, d)) return false;
        t.shape.push_back((long long)d);
      } else {
        return false;
      }
    } else if (field == 2) {  // values, packed doubles
      if (wt != 2 || have_values) return false;  // split packed -> merge
      uint64_t n;
      if (!pw_varint(p, len, pos, n) || pos + n > len || n % 8) return false;
      t.values = p + pos;
      t.nvalues = (long long)(n / 8);
      have_values = true;
      pos += (size_t)n;
    } else {
      if (!pw_skip(p, len, pos, wt)) return false;
    }
  }
  return have_values;
}

bool pw_parse_request(const uint8_t* p, size_t len, PwTensor& t) {
  size_t pos = 0;
  bool seen_meta = false, seen_data = false, have_tensor = false;
  while (pos < len) {
    uint64_t key;
    if (!pw_varint(p, len, pos, key)) return false;
    int field = (int)(key >> 3), wt = (int)(key & 7);
    if (field == 2 && wt == 2) {  // meta
      if (seen_meta) return false;  // repeated -> merge semantics
      seen_meta = true;
      uint64_t n;
      if (!pw_varint(p, len, pos, n) || pos + n > len) return false;
      if (!pw_scan_meta(p + pos, (size_t)n, t.puid)) return false;
      pos += (size_t)n;
    } else if (field == 3 && wt == 2) {  // data
      if (seen_data) return false;
      seen_data = true;
      uint64_t n;
      if (!pw_varint(p, len, pos, n) || pos + n > len) return false;
      const uint8_t* sub = p + pos;
      size_t slen = (size_t)n, spos = 0;
      pos += (size_t)n;
      while (spos < slen) {
        uint64_t skey;
        if (!pw_varint(sub, slen, spos, skey)) return false;
        int sf = (int)(skey >> 3), swt = (int)(skey & 7);
        if (sf == 2 && swt == 2) {  // tensor
          if (have_tensor) return false;
          uint64_t sn;
          if (!pw_varint(sub, slen, spos, sn) || spos + sn > slen)
            return false;
          if (!pw_scan_tensor(sub + spos, (size_t)sn, t)) return false;
          have_tensor = true;
          spos += (size_t)sn;
        } else if (sf == 1 && swt == 2) {  // names: ignored on input
          if (!pw_skip(sub, slen, spos, swt)) return false;
        } else {
          return false;  // ndarray and friends -> full parser
        }
      }
    } else if (field == 1 || field == 4 || field == 5) {
      return false;  // status / binData / strData
    } else {
      if (!pw_skip(p, len, pos, wt)) return false;
    }
  }
  if (!have_tensor) return false;
  if (t.shape.empty()) t.shape.push_back(t.nvalues);
  long long prod = 1;
  for (long long d : t.shape) {
    // overflow-guarded product: a crafted shape like [4, 2^62] must
    // decline (the Python lane's np.reshape raises), not wrap around
    if (d < 0 || (d > 0 && prod > (1LL << 40) / d)) return false;
    prod *= d;
  }
  return prod == t.nvalues && t.nvalues > 0;
}

void pw_append_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) {
    out += (char)((v & 0x7F) | 0x80);
    v >>= 7;
  }
  out += (char)v;
}

void pw_append_len_field(std::string& out, int field,
                         const std::string& payload) {
  out += (char)((field << 3) | 2);
  pw_append_varint(out, payload.size());
  out += payload;
}

// SUCCESS SeldonMessage wire bytes — protowire.build_tensor_response port
std::string pw_build_response(const std::string& puid, const double* y,
                              long long rows, long long cols,
                              const std::string& names_frag) {
  std::string tensor;
  std::string shape_payload;
  pw_append_varint(shape_payload, (uint64_t)rows);
  pw_append_varint(shape_payload, (uint64_t)cols);
  pw_append_len_field(tensor, 1, shape_payload);
  std::string values((const char*)y, (size_t)(rows * cols) * 8);
  pw_append_len_field(tensor, 2, values);
  std::string data = names_frag;
  pw_append_len_field(data, 2, tensor);
  std::string meta;
  pw_append_len_field(meta, 1, puid);
  // Status{code=200, status=SUCCESS(0)}: zero enum omitted on the wire
  std::string status;
  status += (char)0x08;
  pw_append_varint(status, 200);
  std::string out;
  out.reserve(status.size() + meta.size() + data.size() + 16);
  pw_append_len_field(out, 1, status);
  pw_append_len_field(out, 2, meta);
  pw_append_len_field(out, 3, data);
  return out;
}

// --- HTTP/2 connection state ----------------------------------------------

constexpr uint8_t H2_DATA = 0, H2_HEADERS = 1, H2_RST = 3, H2_SETTINGS = 4,
                  H2_PING = 6, H2_GOAWAY = 7, H2_WINDOW_UPDATE = 8,
                  H2_CONTINUATION = 9;
constexpr uint8_t H2F_END_STREAM = 0x1, H2F_ACK = 0x1, H2F_END_HEADERS = 0x4,
                  H2F_PADDED = 0x8, H2F_PRIORITY = 0x20;
constexpr int64_t H2_DEFAULT_WINDOW = 65535;
constexpr int64_t H2_BIG_WINDOW = 0x7fffffff;
constexpr size_t H2_MAX_MESSAGE = 64u * 1024 * 1024;
const char kH2Preface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";

struct H2State {
  bool preface_done = false;
  HpackDec hpack;
  struct Stream {
    std::string path;
    std::string body;
    std::string meta_head;  // bound metadata as "\r\nname: value" lines
  };
  std::unordered_map<uint32_t, Stream> streams;
  size_t buffered = 0;  // sum of open-stream body bytes (backpressure cap)
  // fast-lane / misc work in flight, keyed by stream; false after RST
  std::unordered_map<uint32_t, bool> live;
  int64_t conn_send_window = H2_DEFAULT_WINDOW;
  int64_t peer_initial_window = H2_DEFAULT_WINDOW;
  std::unordered_map<uint32_t, int64_t> stream_windows;
  uint32_t peer_max_frame = 16384;
  uint64_t recv_since_update = 0;
  // flow-stalled sends: payload remainder + trailer per stream, FIFO
  struct Tx {
    uint32_t sid;
    std::string data;
    size_t off;
    std::string trailer;
  };
  std::deque<Tx> txq;
  // CONTINUATION accumulation
  bool in_headers = false;
  uint32_t headers_sid = 0;
  bool headers_end_stream = false;
  std::string headers_accum;
};

void h2_frame_header(std::string& out, uint32_t len, uint8_t type,
                     uint8_t flags, uint32_t sid) {
  out += (char)((len >> 16) & 0xff);
  out += (char)((len >> 8) & 0xff);
  out += (char)(len & 0xff);
  out += (char)type;
  out += (char)flags;
  out += (char)((sid >> 24) & 0x7f);
  out += (char)((sid >> 16) & 0xff);
  out += (char)((sid >> 8) & 0xff);
  out += (char)(sid & 0xff);
}

// response HEADERS / OK-trailers header blocks: static-table + literal
// encodings only (no dynamic-table state), constant for every response
const std::string& h2_resp_headers_block() {
  static const std::string block = [] {
    std::string b;
    b += (char)0x88;  // :status 200 (static index 8)
    // content-type: application/grpc — literal w/o indexing, name idx 31
    b += (char)0x0f;
    b += (char)0x10;
    const char* v = "application/grpc";
    b += (char)strlen(v);
    b += v;
    return b;
  }();
  return block;
}

std::string h2_trailers_block(int grpc_status, const std::string& msg) {
  std::string b;
  auto lit = [&](const char* name, const std::string& value) {
    b += (char)0x00;
    b += (char)strlen(name);
    b += name;
    // 7-bit prefixed length, no huffman
    if (value.size() < 127) {
      b += (char)value.size();
    } else {
      b += (char)0x7f;
      uint64_t v = value.size() - 127;
      while (v >= 0x80) { b += (char)((v & 0x7f) | 0x80); v >>= 7; }
      b += (char)v;
    }
    b += value;
  };
  lit("grpc-status", std::to_string(grpc_status));
  lit("grpc-message", msg.substr(0, 1024));
  return b;
}

void h2_fatal(Plane* pl, int ci, const char* reason) {
  Conn& c = *pl->conns[ci];
  if (c.fd >= 0) {
    std::string go;
    h2_frame_header(go, 8 + (uint32_t)strlen(reason), H2_GOAWAY, 0, 0);
    uint32_t last = 0;
    go += (char)((last >> 24) & 0x7f);
    go += (char)((last >> 16) & 0xff);
    go += (char)((last >> 8) & 0xff);
    go += (char)(last & 0xff);
    uint32_t err = 1;  // PROTOCOL_ERROR
    go += (char)((err >> 24) & 0xff);
    go += (char)((err >> 16) & 0xff);
    go += (char)((err >> 8) & 0xff);
    go += (char)(err & 0xff);
    go += reason;
    (void)!write(c.fd, go.data(), go.size());  // best effort
  }
  conn_close(pl, ci);
}

// append DATA frames for [payload+off ..) within window limits; returns new
// offset.  Trailer is sent once the payload fully drains.
size_t h2_pump_stream(Plane* pl, int ci, uint32_t sid,
                      const std::string& payload, size_t off,
                      const std::string& trailer) {
  Conn& c = *pl->conns[ci];
  H2State& h = *c.h2s;
  while (off < payload.size()) {
    auto itw = h.stream_windows.find(sid);
    int64_t sw = itw != h.stream_windows.end() ? itw->second
                                               : h.peer_initial_window;
    int64_t window = std::min(h.conn_send_window, sw);
    int64_t n = std::min<int64_t>(
        {(int64_t)(payload.size() - off), window, (int64_t)h.peer_max_frame});
    if (n <= 0) return off;  // stalled; resumes on WINDOW_UPDATE
    h2_frame_header(c.out, (uint32_t)n, H2_DATA, 0, sid);
    c.out.append(payload, off, (size_t)n);
    off += (size_t)n;
    h.conn_send_window -= n;
    h.stream_windows[sid] = sw - n;
  }
  c.out += trailer;
  h.stream_windows.erase(sid);
  return off;
}

void h2_pump_txq(Plane* pl, int ci) {
  Conn& c = *pl->conns[ci];
  H2State& h = *c.h2s;
  while (!h.txq.empty()) {
    H2State::Tx& tx = h.txq.front();
    tx.off = h2_pump_stream(pl, ci, tx.sid, tx.data, tx.off, tx.trailer);
    if (tx.off < tx.data.size()) return;  // still stalled
    h.txq.pop_front();
  }
}

// queue a complete gRPC response (HEADERS + DATA + trailers) on the conn
void h2_send_response(Plane* pl, int ci, uint32_t sid,
                      const std::string& grpc_payload) {
  Conn& c = *pl->conns[ci];
  H2State& h = *c.h2s;
  h2_frame_header(c.out, (uint32_t)h2_resp_headers_block().size(), H2_HEADERS,
                  H2F_END_HEADERS, sid);
  c.out += h2_resp_headers_block();
  std::string trailer;
  static const std::string ok_trailers = h2_trailers_block(0, "");
  h2_frame_header(trailer, (uint32_t)ok_trailers.size(), H2_HEADERS,
                  H2F_END_HEADERS | H2F_END_STREAM, sid);
  trailer += ok_trailers;
  if (!h.txq.empty()) {
    // keep per-conn FIFO so stalled streams don't reorder DATA
    h.txq.push_back({sid, grpc_payload, 0, std::move(trailer)});
    h2_pump_txq(pl, ci);
    return;
  }
  size_t off = h2_pump_stream(pl, ci, sid, grpc_payload, 0, trailer);
  if (off < grpc_payload.size())
    h.txq.push_back({sid, grpc_payload.substr(off), 0, std::move(trailer)});
}

void h2_trailers_only(Plane* pl, int ci, uint32_t sid, int grpc_status,
                      const std::string& msg) {
  Conn& c = *pl->conns[ci];
  // every error path ends the stream here: drop its send-window slot
  // (opened at dispatch) or the map grows by one entry per failed RPC
  c.h2s->stream_windows.erase(sid);
  std::string block;
  block += (char)0x88;  // :status 200
  block += (char)0x0f;
  block += (char)0x10;
  const char* v = "application/grpc";
  block += (char)strlen(v);
  block += v;
  block += h2_trailers_block(grpc_status, msg);
  h2_frame_header(c.out, (uint32_t)block.size(), H2_HEADERS,
                  H2F_END_HEADERS | H2F_END_STREAM, sid);
  c.out += block;
}

// a request's :path, and the metadata the Python gRPC lane binds
// (runtime/grpcfast.py: traceparent, seldon-tenant, seldon-tier) as
// "\r\nname: value" lines, the form of an HTTP head
void h2_scan_headers(const std::vector<HeaderPair>& headers, std::string& path,
                     std::string& meta_head) {
  for (auto& hp : headers) {
    if (hp.name == ":path") {
      if (path.empty()) path = hp.value;
    } else if (hp.name == "traceparent" || hp.name == "seldon-tenant" ||
               hp.name == "seldon-tier") {
      meta_head += "\r\n" + hp.name + ": " + hp.value;
    }
  }
}

// dispatch one complete gRPC unary message (frame prefix already verified)
void h2_handle_message(Plane* pl, int ci, uint32_t sid,
                       const std::string& path, std::string&& meta_head,
                       const uint8_t* msg, size_t mlen, bool& want_flush) {
  Conn& c = *pl->conns[ci];
  H2State& h = *c.h2s;
  want_flush = true;
  // Model alias == Seldon service: an engine composes as a MODEL leaf of
  // a larger cross-process graph (grpc_server.make_engine_grpc_server)
  // metadata the Python lane binds (a trace parent, a QoS identity) takes
  // the misc lane, which binds it
  if (meta_head.empty() && (path == "/seldon.protos.Seldon/Predict" ||
                            path == "/seldon.protos.Model/Predict")) {
    PwTensor t;
    if (pw_parse_request(msg, mlen, t)) {
      long long rows = t.shape.size() >= 2 ? t.shape[0] : 1;
      long long width = t.shape.size() >= 2 ? t.nvalues / t.shape[0]
                                            : t.nvalues;
      // >2-D tensors flatten per leading dim like protowire's reshape
      if (rows > 0 && width > 0 && rows * width == t.nvalues &&
          rows <= pl->max_batch) {
        ReqInfo r;
        r.conn_id = ci;
        r.conn_gen = c.gen;
        r.seq = 0;
        r.kind = KIND_PROTO;
        r.rows = rows;
        r.h2 = true;
        r.stream = sid;
        r.puid = std::move(t.puid);
        r.t0 = now_s();
        // packed doubles are little-endian on the wire; memcpy inside
        // enqueue_rows is exact on this platform (x86/ARM LE)
        if (!enqueue_rows(pl, std::move(r), t.values, rows, width)) {
          h2_trailers_only(pl, ci, sid, 8 /* RESOURCE_EXHAUSTED */,
                           "overloaded");
          return;
        }
        h.live[sid] = true;
        // open the send window slot now so stream WINDOW_UPDATEs arriving
        // before the response (INITIAL_WINDOW_SIZE=0 clients) accumulate
        h.stream_windows.emplace(sid, h.peer_initial_window);
        return;
      }
    }
  }
  // misc lane: full protobuf/service semantics in Python
  auto m = std::make_unique<MiscReq>();
  m->conn_id = ci;
  m->conn_gen = c.gen;
  m->seq = 0;
  m->close_c = false;
  m->method = "GRPC";
  m->path = path;
  m->body.assign((const char*)msg, mlen);
  m->head = std::move(meta_head);
  h.live[sid] = true;
  h.stream_windows.emplace(sid, h.peer_initial_window);
  m->h2 = true;
  m->stream = sid;
  std::lock_guard<std::mutex> lk(pl->mu);
  m->id = pl->next_misc_id++;
  pl->misc_q.push_back(std::move(m));
  pl->cv_misc.notify_one();
}

void h2_parse(Plane* pl, int ci) {
  Conn& c = *pl->conns[ci];
  H2State& h = *c.h2s;
  size_t consumed = 0;
  bool want_flush = false;
  while (c.fd >= 0) {
    if (!h.preface_done) {
      if (c.in.size() - consumed < 24) break;
      if (memcmp(c.in.data() + consumed, kH2Preface, 24) != 0) {
        h2_fatal(pl, ci, "bad preface");
        return;
      }
      consumed += 24;
      h.preface_done = true;
      continue;
    }
    if (c.in.size() - consumed < 9) break;
    const uint8_t* p = (const uint8_t*)c.in.data() + consumed;
    uint32_t len = (p[0] << 16) | (p[1] << 8) | p[2];
    if (len > (1u << 24) - 1 || len > 16u * 1024 * 1024) {
      h2_fatal(pl, ci, "frame too large");
      return;
    }
    if (c.in.size() - consumed < 9 + (size_t)len) break;
    uint8_t type = p[3], flags = p[4];
    uint32_t sid = ((p[5] & 0x7f) << 24) | (p[6] << 16) | (p[7] << 8) | p[8];
    const uint8_t* payload = p + 9;
    consumed += 9 + len;
    if (h.in_headers && type != H2_CONTINUATION) {
      h2_fatal(pl, ci, "expected CONTINUATION");
      return;
    }
    switch (type) {
      case H2_SETTINGS: {
        if (flags & H2F_ACK) break;
        if (len % 6) { h2_fatal(pl, ci, "bad SETTINGS"); return; }
        for (uint32_t i = 0; i + 6 <= len; i += 6) {
          uint16_t k = (payload[i] << 8) | payload[i + 1];
          uint32_t v = (payload[i + 2] << 24) | (payload[i + 3] << 16) |
                       (payload[i + 4] << 8) | payload[i + 5];
          if (k == 0x4) {  // INITIAL_WINDOW_SIZE
            int64_t delta = (int64_t)v - h.peer_initial_window;
            h.peer_initial_window = v;
            for (auto& kv : h.stream_windows) kv.second += delta;
          } else if (k == 0x5) {  // MAX_FRAME_SIZE
            if (v >= 16384 && v <= 16777215) h.peer_max_frame = v;
          }
        }
        h2_frame_header(c.out, 0, H2_SETTINGS, H2F_ACK, 0);
        h2_pump_txq(pl, ci);  // a raised INITIAL_WINDOW_SIZE unstalls
        want_flush = true;
        break;
      }
      case H2_PING:
        if (!(flags & H2F_ACK) && len == 8) {
          h2_frame_header(c.out, 8, H2_PING, H2F_ACK, 0);
          c.out.append((const char*)payload, 8);
          want_flush = true;
        }
        break;
      case H2_WINDOW_UPDATE: {
        if (len != 4) { h2_fatal(pl, ci, "bad WINDOW_UPDATE"); return; }
        uint32_t inc = ((payload[0] & 0x7f) << 24) | (payload[1] << 16) |
                       (payload[2] << 8) | payload[3];
        if (sid == 0) h.conn_send_window += inc;
        else {
          auto it = h.stream_windows.find(sid);
          if (it != h.stream_windows.end()) it->second += inc;
        }
        h2_pump_txq(pl, ci);
        want_flush = true;
        break;
      }
      case H2_HEADERS: {
        size_t off = 0;
        uint8_t pad = 0;
        if (flags & H2F_PADDED) { if (len < 1) { h2_fatal(pl, ci, "pad"); return; } pad = payload[off++]; }
        if (flags & H2F_PRIORITY) { off += 5; }
        if (off + pad > len) { h2_fatal(pl, ci, "pad"); return; }
        h.headers_sid = sid;
        h.headers_end_stream = flags & H2F_END_STREAM;
        h.headers_accum.assign((const char*)payload + off,
                               len - off - pad);
        if (flags & H2F_END_HEADERS) {
          std::vector<HeaderPair> headers;
          if (!h.hpack.decode((const uint8_t*)h.headers_accum.data(),
                              h.headers_accum.size(), headers)) {
            h2_fatal(pl, ci, "hpack error");
            return;
          }
          std::string path, meta_head;
          h2_scan_headers(headers, path, meta_head);
          if (h.streams.size() >= 65536) {
            h2_fatal(pl, ci, "too many open streams");
            return;
          }
          h.streams[sid] = {std::move(path), {}, std::move(meta_head)};
          if (h.headers_end_stream) {
            h.streams.erase(sid);
            h2_trailers_only(pl, ci, sid, 13, "missing request body");
            want_flush = true;
          }
        } else {
          h.in_headers = true;
        }
        break;
      }
      case H2_CONTINUATION: {
        if (!h.in_headers || sid != h.headers_sid) {
          h2_fatal(pl, ci, "unexpected CONTINUATION");
          return;
        }
        h.headers_accum.append((const char*)payload, len);
        if (h.headers_accum.size() > 1u << 20) {
          h2_fatal(pl, ci, "headers too large");
          return;
        }
        if (flags & H2F_END_HEADERS) {
          h.in_headers = false;
          std::vector<HeaderPair> headers;
          if (!h.hpack.decode((const uint8_t*)h.headers_accum.data(),
                              h.headers_accum.size(), headers)) {
            h2_fatal(pl, ci, "hpack error");
            return;
          }
          std::string path, meta_head;
          h2_scan_headers(headers, path, meta_head);
          h.streams[h.headers_sid] = {std::move(path), {},
                                      std::move(meta_head)};
          if (h.headers_end_stream) {
            h.streams.erase(h.headers_sid);
            h2_trailers_only(pl, ci, h.headers_sid, 13,
                             "missing request body");
            want_flush = true;
          }
        }
        break;
      }
      case H2_DATA: {
        size_t off = 0;
        uint8_t pad = 0;
        if (flags & H2F_PADDED) { if (len < 1) { h2_fatal(pl, ci, "pad"); return; } pad = payload[off++]; }
        if (off + pad > len) { h2_fatal(pl, ci, "pad"); return; }
        h.recv_since_update += len;
        if (h.recv_since_update >= (1u << 20)) {
          h2_frame_header(c.out, 4, H2_WINDOW_UPDATE, 0, 0);
          uint32_t inc = (uint32_t)h.recv_since_update;
          c.out += (char)((inc >> 24) & 0x7f);
          c.out += (char)((inc >> 16) & 0xff);
          c.out += (char)((inc >> 8) & 0xff);
          c.out += (char)(inc & 0xff);
          h.recv_since_update = 0;
          want_flush = true;
        }
        auto it = h.streams.find(sid);
        if (it == h.streams.end()) break;  // unknown/aborted stream
        it->second.body.append((const char*)payload + off, len - off - pad);
        h.buffered += len - off - pad;
        if (it->second.body.size() > H2_MAX_MESSAGE + 5) {
          h.buffered -= it->second.body.size();
          h2_trailers_only(pl, ci, sid, 8, "message too large");
          h.streams.erase(it);
          want_flush = true;
          break;
        }
        if (h.buffered > 256u * 1024 * 1024) {
          // connection-level memory backstop: a client streaming unbounded
          // bodies across many open streams is killed, the same budget the
          // HTTP lane enforces per body (_MAX_BODY)
          h2_fatal(pl, ci, "connection buffer budget exceeded");
          return;
        }
        if (flags & H2F_END_STREAM) {
          std::string path = std::move(it->second.path);
          std::string body = std::move(it->second.body);
          std::string meta_head = std::move(it->second.meta_head);
          h.buffered -= body.size();
          h.streams.erase(it);
          if (body.size() < 5 || body[0] != 0) {
            h2_trailers_only(pl, ci, sid, 13,
                             "compressed or malformed grpc frame");
            want_flush = true;
            break;
          }
          uint32_t mlen = ((uint8_t)body[1] << 24) | ((uint8_t)body[2] << 16) |
                          ((uint8_t)body[3] << 8) | (uint8_t)body[4];
          if (mlen != body.size() - 5) {
            h2_trailers_only(pl, ci, sid, 13, "grpc frame length mismatch");
            want_flush = true;
            break;
          }
          bool wf = false;
          h2_handle_message(pl, ci, sid, path, std::move(meta_head),
                            (const uint8_t*)body.data() + 5, mlen, wf);
          want_flush = want_flush || wf;
        }
        break;
      }
      case H2_RST: {
        auto sit = h.streams.find(sid);
        if (sit != h.streams.end()) {
          h.buffered -= sit->second.body.size();
          h.streams.erase(sit);
        }
        h.stream_windows.erase(sid);
        auto it = h.live.find(sid);
        if (it != h.live.end()) it->second = false;  // drop the response
        // purge any flow-stalled response for the cancelled stream: the
        // client will never grant it window, and a stalled txq head would
        // head-of-line-block every later response on this connection
        for (auto tit = h.txq.begin(); tit != h.txq.end();) {
          if (tit->sid == sid) tit = h.txq.erase(tit);
          else ++tit;
        }
        h2_pump_txq(pl, ci);
        want_flush = true;
        break;
      }
      case H2_GOAWAY:
        conn_close(pl, ci);
        return;
      default:
        break;  // PRIORITY / PUSH_PROMISE / unknown: ignore
    }
  }
  if (c.fd >= 0 && consumed) c.in.erase(0, consumed);
  if (c.fd >= 0 && want_flush) conn_flush(pl, ci);
}

void drain_completions(Plane* pl) {
  uint64_t junk;
  (void)!read(pl->evfd, &junk, 8);
  std::vector<Plane::Completion> local;
  {
    std::lock_guard<std::mutex> lk(pl->cmu);
    local.swap(pl->completions);
  }
  // group flushes: mark conns dirty, flush each once
  std::vector<int> dirty;
  for (auto& item : local) {
    int ci = item.conn_id;
    if (ci < 0 || ci >= (int)pl->conns.size()) continue;
    Conn& c = *pl->conns[ci];
    if (c.fd < 0 || c.gen != item.gen) continue;  // conn died meanwhile
    if (item.h2) {
      H2State& h = *c.h2s;
      auto it = h.live.find(item.stream);
      bool alive = it == h.live.end() || it->second;  // RST'd -> drop
      if (it != h.live.end()) h.live.erase(it);
      if (!alive) {
        h.stream_windows.erase(item.stream);
        continue;
      }
      if (item.grpc_status == 0)
        h2_send_response(pl, ci, item.stream, item.data);
      else
        h2_trailers_only(pl, ci, item.stream, item.grpc_status, item.data);
    } else {
      c.done[item.seq] = std::move(item.data);
    }
    dirty.push_back(ci);
  }
  std::sort(dirty.begin(), dirty.end());
  dirty.erase(std::unique(dirty.begin(), dirty.end()), dirty.end());
  for (int ci : dirty) conn_flush(pl, ci);
}

void io_loop(Plane* pl) {
  std::vector<struct epoll_event> events(512);
  while (!pl->stop.load(std::memory_order_relaxed)) {
    // batch deadline: the oldest open accumulation decides the poll timeout
    int timeout_ms = 1000;
    {
      std::lock_guard<std::mutex> lk(pl->mu);
      if (!pl->accum.empty() && pl->inflight_count < pl->depth) {
        double oldest = 1e300;
        for (auto& kv : pl->accum)
          if (kv.second && kv.second->t_first < oldest)
            oldest = kv.second->t_first;
        double dl = oldest + pl->max_wait_s - now_s();
        timeout_ms = dl <= 0 ? 0 : (int)(dl * 1000) + 1;
      }
    }
    int n = epoll_wait(pl->ep, events.data(), (int)events.size(), timeout_ms);
    if (n < 0 && errno != EINTR) break;
    for (int e = 0; e < n; e++) {
      int idx = (int)(int32_t)events[e].data.u64;
      if (idx == EvTag::LISTEN || idx == EvTag::LISTEN_GRPC) {
        bool h2 = idx == EvTag::LISTEN_GRPC;
        int lfd = h2 ? pl->grpc_listen_fd : pl->listen_fd;
        for (;;) {
          int fd = accept4(lfd, nullptr, nullptr, SOCK_NONBLOCK);
          if (fd < 0) break;
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          int ci;
          if (!pl->free_conns.empty()) {
            ci = pl->free_conns.back();
            pl->free_conns.pop_back();
          } else {
            ci = (int)pl->conns.size();
            pl->conns.emplace_back(new Conn());
          }
          Conn& c = *pl->conns[ci];
          c.fd = fd;
          c.h2 = h2;
          c.scan_from = 0;
          c.head_end = -1;
          c.clen = -1;
          c.head_parsed = false;
          c.next_assign = c.next_write = 0;
          c.close_after = UINT64_MAX;
          c.out_off = 0;
          c.want_write = false;
          c.paused = false;
          if (h2) {
            c.h2s.reset(new H2State());
            // server bootstrap: big receive windows so uploads never
            // stall on us (the same bootstrap grpcfast.py performs)
            std::string boot;
            h2_frame_header(boot, 12, H2_SETTINGS, 0, 0);
            auto put_setting = [&](uint16_t k, uint32_t v) {
              boot += (char)(k >> 8);
              boot += (char)(k & 0xff);
              boot += (char)((v >> 24) & 0xff);
              boot += (char)((v >> 16) & 0xff);
              boot += (char)((v >> 8) & 0xff);
              boot += (char)(v & 0xff);
            };
            put_setting(0x4, (uint32_t)H2_BIG_WINDOW);
            put_setting(0x3, 1u << 20);
            h2_frame_header(boot, 4, H2_WINDOW_UPDATE, 0, 0);
            uint32_t inc = (uint32_t)(H2_BIG_WINDOW - H2_DEFAULT_WINDOW);
            boot += (char)((inc >> 24) & 0x7f);
            boot += (char)((inc >> 16) & 0xff);
            boot += (char)((inc >> 8) & 0xff);
            boot += (char)(inc & 0xff);
            c.out += boot;
          } else {
            c.h2s.reset();
          }
          arm(pl, fd, ci, EPOLLIN, EPOLL_CTL_ADD);
          if (h2) conn_flush(pl, ci);
        }
        continue;
      }
      if (idx == EvTag::EVENT) {
        drain_completions(pl);
        continue;
      }
      if (idx < 0 || idx >= (int)pl->conns.size()) continue;
      Conn& c = *pl->conns[idx];
      if (c.fd < 0) continue;
      if (events[e].events & (EPOLLERR | EPOLLHUP)) {
        conn_close(pl, idx);
        continue;
      }
      if (events[e].events & EPOLLOUT) conn_flush(pl, idx);
      if (c.fd >= 0 && (events[e].events & EPOLLIN)) {
        conn_data(pl, idx);
        if (c.fd >= 0) conn_flush(pl, idx);  // parse-path responses
      }
    }
    if (!pl->resume_parse.empty()) {
      // connections that resumed from backpressure may hold complete
      // buffered requests that arrived while reading was paused
      std::vector<int> resumed;
      resumed.swap(pl->resume_parse);
      for (int ci : resumed) {
        if (pl->conns[ci]->fd < 0) continue;
        if (pl->conns[ci]->h2) h2_parse(pl, ci);
        else conn_parse(pl, ci);
        if (pl->conns[ci]->fd >= 0) conn_flush(pl, ci);
      }
    }
    // flush aged batches
    {
      std::lock_guard<std::mutex> lk(pl->mu);
      if (pl->inflight_count < pl->depth) {
        double now = now_s();
        std::vector<long long> due;
        for (auto& kv : pl->accum)
          if (kv.second && now - kv.second->t_first >= pl->max_wait_s)
            due.push_back(kv.first);
        for (long long w : due) flush_batch_locked(pl, w);
      }
    }
  }
  // shutdown: close everything
  for (size_t i = 0; i < pl->conns.size(); i++)
    if (pl->conns[i]->fd >= 0) conn_close(pl, (int)i);
  if (pl->listen_fd >= 0) close(pl->listen_fd);
  if (pl->grpc_listen_fd >= 0) close(pl->grpc_listen_fd);
  pl->cv_batch.notify_all();
  pl->cv_misc.notify_all();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

struct DpBatchView {
  long long id;
  long long rows;
  long long width;
  const double* data;
};

struct DpMiscView {
  long long id;
  const char* method;
  long long method_len;
  const char* path;
  long long path_len;
  const char* query;
  long long query_len;
  const char* ctype;
  long long ctype_len;
  const char* body;
  long long body_len;
  const char* head;
  long long head_len;
};

static int dp_listen(const char* host, int port, int* bound_port) {
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof addr);
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host && *host ? host : "0.0.0.0", &addr.sin_addr) != 1)
    addr.sin_addr.s_addr = INADDR_ANY;
  if (bind(fd, (struct sockaddr*)&addr, sizeof addr) < 0 ||
      listen(fd, 4096) < 0) {
    close(fd);
    return -1;
  }
  socklen_t alen = sizeof addr;
  getsockname(fd, (struct sockaddr*)&addr, &alen);
  if (bound_port) *bound_port = ntohs(addr.sin_port);
  return fd;
}

// grpc_port: -1 disables the gRPC lane, 0 binds an ephemeral port
void* dp_start(const char* host, int port, int grpc_port, long long max_batch,
               double max_wait_ms, int depth, const char* names_frag,
               long long names_len, const char* proto_names,
               long long proto_names_len) {
  auto pl = std::make_unique<Plane>();
  pl->max_batch = max_batch > 0 ? max_batch : 1024;
  pl->max_wait_s = max_wait_ms > 0 ? max_wait_ms / 1e3 : 0.002;
  pl->depth = depth > 0 ? depth : 8;
  if (names_frag && names_len > 0) pl->names_frag.assign(names_frag, names_len);
  if (proto_names && proto_names_len > 0)
    pl->proto_names_frag.assign(proto_names, proto_names_len);

  pl->listen_fd = dp_listen(host, port, &pl->port);
  if (pl->listen_fd < 0) return nullptr;
  if (grpc_port >= 0) {
    pl->grpc_listen_fd = dp_listen(host, grpc_port, &pl->grpc_port);
    if (pl->grpc_listen_fd < 0) {
      close(pl->listen_fd);
      return nullptr;
    }
  }

  pl->ep = epoll_create1(0);
  pl->evfd = eventfd(0, EFD_NONBLOCK);
  arm(pl.get(), pl->listen_fd, EvTag::LISTEN, EPOLLIN, EPOLL_CTL_ADD);
  if (pl->grpc_listen_fd >= 0)
    arm(pl.get(), pl->grpc_listen_fd, EvTag::LISTEN_GRPC, EPOLLIN,
        EPOLL_CTL_ADD);
  arm(pl.get(), pl->evfd, EvTag::EVENT, EPOLLIN, EPOLL_CTL_ADD);
  Plane* raw = pl.release();
  raw->io_thread = std::thread(io_loop, raw);
  return raw;
}

int dp_port(void* h) { return h ? ((Plane*)h)->port : 0; }
int dp_grpc_port(void* h) { return h ? ((Plane*)h)->grpc_port : 0; }

int dp_next_batch(void* h, DpBatchView* out) {
  Plane* pl = (Plane*)h;
  std::unique_lock<std::mutex> lk(pl->mu);
  pl->cv_batch.wait(lk, [&] {
    return pl->stop.load(std::memory_order_relaxed) || !pl->ready.empty();
  });
  if (pl->ready.empty()) return 0;  // shutdown
  std::unique_ptr<Batch> b = std::move(pl->ready.front());
  pl->ready.pop_front();
  pl->queued_rows -= (long long)(b->data.size() / b->width);
  pl->inflight_count++;
  Batch* bp = b.get();
  pl->inflight[bp->id] = std::move(b);
  out->id = bp->id;
  out->width = bp->width;
  out->rows = (long long)(bp->data.size() / bp->width);
  out->data = bp->data.data();
  return 1;
}

static std::unique_ptr<Batch> take_inflight(Plane* pl, long long id) {
  std::lock_guard<std::mutex> lk(pl->mu);
  auto it = pl->inflight.find(id);
  if (it == pl->inflight.end()) return nullptr;
  std::unique_ptr<Batch> b = std::move(it->second);
  pl->inflight.erase(it);
  pl->inflight_count--;
  // a slot opened: if nothing else is ready, release the oldest accumulation
  if (pl->ready.empty() && !pl->accum.empty()) {
    long long oldest_w = -1;
    double oldest_t = 1e300;
    for (auto& kv : pl->accum)
      if (kv.second && kv.second->t_first < oldest_t) {
        oldest_t = kv.second->t_first;
        oldest_w = kv.first;
      }
    if (oldest_w >= 0) flush_batch_locked(pl, oldest_w);
  }
  return b;
}

int dp_complete_batch(void* h, long long id, const double* y, long long rows,
                      long long cols) {
  Plane* pl = (Plane*)h;
  std::unique_ptr<Batch> b = take_inflight(pl, id);
  if (!b) return -1;
  long long in_rows = (long long)(b->data.size() / b->width);
  if (rows != in_rows || cols <= 0 || !y) {
    // row-count mismatch is a server defect: fail every caller
    for (ReqInfo& r : b->reqs) {
      (r.h2 ? pl->stats_h2 : pl->stats)
          .n5xx.fetch_add(1, std::memory_order_relaxed);
      if (r.h2) {
        queue_completion_h2(pl, r.conn_id, r.conn_gen, r.stream,
                            13 /* INTERNAL */, "batch shape mismatch");
        continue;
      }
      std::string body =
          "{\"status\":{\"code\":500,\"status\":\"FAILURE\","
          "\"reason\":\"batch shape mismatch\"}}";
      queue_completion(pl, r,
                       http_response(500, "application/json", body.data(),
                                     body.size(), r.close_c));
    }
    return 0;
  }
  long long off = 0;
  double tdone = now_s();
  for (ReqInfo& r : b->reqs) {
    if (r.h2) {
      // gRPC lane: proto wire response + 5-byte message frame
      std::string puid = r.puid;
      if (puid.empty()) {
        char pbuf[26];
        pl->puid.fill(pbuf);
        puid.assign(pbuf, 26);
      }
      std::string proto = pw_build_response(
          puid, y + off * cols, r.rows, cols, pl->proto_names_frag);
      off += r.rows;
      std::string framed;
      framed.reserve(proto.size() + 5);
      framed += (char)0;
      framed += (char)((proto.size() >> 24) & 0xff);
      framed += (char)((proto.size() >> 16) & 0xff);
      framed += (char)((proto.size() >> 8) & 0xff);
      framed += (char)(proto.size() & 0xff);
      framed += proto;
      pl->stats_h2.observe_ok(tdone - r.t0);
      queue_completion_h2(pl, r.conn_id, r.conn_gen, r.stream, 0,
                          std::move(framed));
      continue;
    }
    long long shape[2] = {r.rows, cols};
    long long frag_len = 0;
    char* frag = sm_format(y + off * cols, shape, 2, r.kind, &frag_len);
    off += r.rows;
    if (!frag) {
      // never skip a seq: an unanswered slot would wedge the connection's
      // ordered response queue forever (conn_flush stops at a gap)
      std::string err =
          "{\"status\":{\"code\":500,\"status\":\"FAILURE\","
          "\"reason\":\"response format failed\"}}";
      pl->stats.n5xx.fetch_add(1, std::memory_order_relaxed);
      queue_completion(pl, r,
                       http_response(500, "application/json", err.data(),
                                     err.size(), r.close_c));
      continue;
    }
    std::string meta = response_meta(pl, r.meta);
    std::string body;
    body.reserve(meta.size() + pl->names_frag.size() + (size_t)frag_len + 96);
    body += "{\"meta\":";
    body += meta;
    body += ",\"status\":{\"code\":200,\"status\":\"SUCCESS\"},\"data\":{";
    body += pl->names_frag;
    body.append(frag, (size_t)frag_len);
    body += "}}";
    sm_buf_free(frag);
    pl->stats.observe_ok(tdone - r.t0);
    queue_completion(pl, r,
                     http_response(200, "application/json", body.data(),
                                   body.size(), r.close_c));
  }
  return 0;
}

// A failed batch.  `body` is the JSON answer without its meta
// ({"status":{...}}: each HTTP caller's answer gets {"meta":{"puid":..},
// prepended, as the Python lane writes it) or, when it does not begin so,
// sent as it is.  `proto_status`, when given, is a SeldonMessage's status
// field (field 1, tag included): each gRPC caller is answered OK with that
// message plus its meta, as the Python gRPC lane answers a FAILURE;
// without it a gRPC caller gets the status mapped to a grpc-status.
int dp_fail_batch(void* h, long long id, int http_code, const char* body,
                  long long body_len, const char* proto_status,
                  long long proto_status_len) {
  Plane* pl = (Plane*)h;
  std::unique_ptr<Batch> b = take_inflight(pl, id);
  if (!b) return -1;
  std::string bs(body ? body : "", body ? (size_t)body_len : 0);
  if (bs.empty())
    bs = "{\"status\":{\"code\":500,\"status\":\"FAILURE\"}}";
  const bool with_meta = bs.compare(0, 10, "{\"status\":") == 0;
  std::string ps(proto_status ? proto_status : "",
                 proto_status ? (size_t)proto_status_len : 0);
  // gRPC status mapping for h2 callers in the same failed batch
  int grpc_status = http_code == 400 ? 3 /* INVALID_ARGUMENT */
                    : http_code == 503 ? 8 /* RESOURCE_EXHAUSTED */
                    : http_code == 504 ? 4 /* DEADLINE_EXCEEDED */
                                       : 13 /* INTERNAL */;
  for (ReqInfo& r : b->reqs) {
    Stats& st = r.h2 ? pl->stats_h2 : pl->stats;
    if (r.h2) {
      if (!ps.empty()) {
        // a FAILURE message answered OK, as the Python gRPC lane does
        std::string puid = r.puid;
        if (puid.empty()) {
          char pbuf[26];
          pl->puid.fill(pbuf);
          puid.assign(pbuf, 26);
        }
        std::string meta;
        pw_append_len_field(meta, 1, puid);
        std::string proto = ps;
        pw_append_len_field(proto, 2, meta);
        std::string framed;
        framed.reserve(proto.size() + 5);
        framed += (char)0;
        framed += (char)((proto.size() >> 24) & 0xff);
        framed += (char)((proto.size() >> 16) & 0xff);
        framed += (char)((proto.size() >> 8) & 0xff);
        framed += (char)(proto.size() & 0xff);
        framed += proto;
        st.n2xx.fetch_add(1, std::memory_order_relaxed);
        queue_completion_h2(pl, r.conn_id, r.conn_gen, r.stream, 0,
                            std::move(framed));
        continue;
      }
      if (http_code >= 500) st.n5xx.fetch_add(1, std::memory_order_relaxed);
      else if (http_code >= 400) st.n4xx.fetch_add(1, std::memory_order_relaxed);
      // same diagnostic text the HTTP callers get (trimmed for grpc-message)
      queue_completion_h2(pl, r.conn_id, r.conn_gen, r.stream, grpc_status,
                          std::string(bs));
      continue;
    }
    if (http_code >= 500) st.n5xx.fetch_add(1, std::memory_order_relaxed);
    else if (http_code >= 400) st.n4xx.fetch_add(1, std::memory_order_relaxed);
    std::string answer;
    if (with_meta) {
      answer = "{\"meta\":" + response_meta(pl, r.meta) + ",";
      answer.append(bs, 1, std::string::npos);
    } else {
      answer = bs;
    }
    queue_completion(pl, r,
                     http_response(http_code, "application/json",
                                   answer.data(), answer.size(), r.close_c));
  }
  return 0;
}

int dp_next_misc(void* h, DpMiscView* out) {
  Plane* pl = (Plane*)h;
  std::unique_lock<std::mutex> lk(pl->mu);
  pl->cv_misc.wait(lk, [&] {
    return pl->stop.load(std::memory_order_relaxed) || !pl->misc_q.empty();
  });
  if (pl->misc_q.empty()) return 0;  // shutdown
  std::unique_ptr<MiscReq> m = std::move(pl->misc_q.front());
  pl->misc_q.pop_front();
  MiscReq* mp = m.get();
  pl->misc_inflight[mp->id] = std::move(m);
  out->id = mp->id;
  out->method = mp->method.data();
  out->method_len = (long long)mp->method.size();
  out->path = mp->path.data();
  out->path_len = (long long)mp->path.size();
  out->query = mp->query.data();
  out->query_len = (long long)mp->query.size();
  out->ctype = mp->ctype.data();
  out->ctype_len = (long long)mp->ctype.size();
  out->body = mp->body.data();
  out->body_len = (long long)mp->body.size();
  out->head = mp->head.data();
  out->head_len = (long long)mp->head.size();
  return 1;
}

// gRPC misc response: status 0 sends payload + OK trailers, else
// trailers-only with `message`
int dp_respond_grpc(void* h, long long id, int grpc_status,
                    const char* message, long long message_len,
                    const char* payload, long long payload_len) {
  Plane* pl = (Plane*)h;
  std::unique_ptr<MiscReq> m;
  {
    std::lock_guard<std::mutex> lk(pl->mu);
    auto it = pl->misc_inflight.find(id);
    if (it == pl->misc_inflight.end()) return -1;
    m = std::move(it->second);
    pl->misc_inflight.erase(it);
  }
  if (!m->h2) return -1;
  if (grpc_status == 0)
    pl->stats_h2.n2xx.fetch_add(1, std::memory_order_relaxed);
  else
    pl->stats_h2.n5xx.fetch_add(1, std::memory_order_relaxed);
  std::string data;
  if (grpc_status == 0) {
    size_t n = payload ? (size_t)payload_len : 0;
    data.reserve(n + 5);
    data += (char)0;
    data += (char)((n >> 24) & 0xff);
    data += (char)((n >> 16) & 0xff);
    data += (char)((n >> 8) & 0xff);
    data += (char)(n & 0xff);
    data.append(payload ? payload : "", n);
  } else {
    data.assign(message ? message : "", message ? (size_t)message_len : 0);
  }
  queue_completion_h2(pl, m->conn_id, m->conn_gen, m->stream, grpc_status,
                      std::move(data));
  return 0;
}

int dp_respond_misc(void* h, long long id, int http_code, const char* ctype,
                    const char* body, long long body_len) {
  Plane* pl = (Plane*)h;
  std::unique_ptr<MiscReq> m;
  {
    std::lock_guard<std::mutex> lk(pl->mu);
    auto it = pl->misc_inflight.find(id);
    if (it == pl->misc_inflight.end()) return -1;
    m = std::move(it->second);
    pl->misc_inflight.erase(it);
  }
  if (m->h2) return -1;  // gRPC misc must answer via dp_respond_grpc
  if (http_code >= 500) pl->stats.n5xx.fetch_add(1, std::memory_order_relaxed);
  else if (http_code >= 400) pl->stats.n4xx.fetch_add(1, std::memory_order_relaxed);
  else pl->stats.n2xx.fetch_add(1, std::memory_order_relaxed);
  ReqInfo r;
  r.conn_id = m->conn_id;
  r.conn_gen = m->conn_gen;
  r.seq = m->seq;
  queue_completion(
      pl, r,
      http_response(http_code, ctype && *ctype ? ctype : "application/json",
                    body ? body : "", body ? (size_t)body_len : 0,
                    m->close_c));
  return 0;
}

// Two 19-slot blocks, one per fast lane:
//   out[0..18]  HTTP/1.1: 2xx/4xx/5xx, latency sum (us), 15 hist buckets
//   out[19..37] h2/gRPC:  same layout
// Keeping the lanes separate lets /prometheus attribute REST vs gRPC
// traffic to distinct metric children (parity with the Python lanes).
void dp_stats(void* h, long long* out) {
  Plane* pl = (Plane*)h;
  Stats* lanes[2] = {&pl->stats, &pl->stats_h2};
  for (int l = 0; l < 2; l++) {
    long long* o = out + 19 * l;
    Stats& s = *lanes[l];
    o[0] = s.n2xx.load(std::memory_order_relaxed);
    o[1] = s.n4xx.load(std::memory_order_relaxed);
    o[2] = s.n5xx.load(std::memory_order_relaxed);
    o[3] = s.sum_us.load(std::memory_order_relaxed);
    for (int i = 0; i < 15; i++)
      o[4 + i] = s.hist[i].load(std::memory_order_relaxed);
  }
}

// Two-phase shutdown: dp_shutdown stops IO and wakes blocked workers but
// keeps the Plane alive so threads mid-call (dp_next_* / dp_complete_* /
// dp_respond_misc) stay memory-safe; dp_destroy frees it once the caller
// has joined its worker threads.
void dp_shutdown(void* h) {
  Plane* pl = (Plane*)h;
  pl->stop.store(true, std::memory_order_relaxed);
  uint64_t one = 1;
  (void)!write(pl->evfd, &one, 8);
  pl->cv_batch.notify_all();
  pl->cv_misc.notify_all();
  if (pl->io_thread.joinable()) pl->io_thread.join();
}

void dp_destroy(void* h) {
  Plane* pl = (Plane*)h;
  close(pl->ep);
  close(pl->evfd);
  delete pl;
}

void dp_stop(void* h) {  // single-phase convenience for single-threaded use
  dp_shutdown(h);
  dp_destroy(h);
}

}  // extern "C"

// loadgen — a closed-loop load generator for the engine's socketed lanes.
//
// A Python client pays per request what it measures, and on a host that
// shares its cores with the server it charges that cost to the server's
// budget.  This client does a few microseconds of work a request:
//
//   REST mode: HTTP/1.1 keepalive, one connection per client, each client a
//     closed loop (request -> full response -> next request).
//   GRPC mode: HTTP/2 gRPC unary (RFC 7540 framing), K clients multiplexed
//     over a few connections.
//
// The request bytes are prepared by the caller (chip_smoke.py's native
// phase): REST gets the verbatim HTTP/1.1 request; gRPC gets a replayable
// HPACK header block (static/literal-only, no dynamic-table state) plus the
// framed message body.  Single thread, epoll, level-triggered.  An HTTP answer
// whose status is not 2xx counts as a failure.
//
// Usage:
//   loadgen --host H --port P --api rest|grpc --clients N [--conns C]
//           --duration S --warmup S --request-file F [--headers-file F]
// Prints one JSON line: {"requests":..,"failures":..,"qps":..,"p50_ms":..,...}

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

namespace {

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "loadgen: cannot open %s\n", path); exit(2); }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (n && fread(buf.data(), 1, n, f) != (size_t)n) {
    fprintf(stderr, "loadgen: short read %s\n", path); exit(2);
  }
  fclose(f);
  return buf;
}

struct Stats {
  std::vector<float> lat_ms;
  uint64_t failures = 0;
  void reset() { lat_ms.clear(); failures = 0; }
};

double pct(std::vector<float>& v, double p) {
  if (v.empty()) return 0.0;
  size_t k = (size_t)(p / 100.0 * (v.size() - 1) + 0.5);
  std::nth_element(v.begin(), v.begin() + k, v.end());
  return v[k];
}

// Resolve a host name to an IPv4 dotted literal ("localhost" -> "127.0.0.1");
// returns the input unchanged if it already is one, empty string on failure.
std::string resolve_ipv4(const char* host) {
  struct in_addr probe;
  if (inet_pton(AF_INET, host, &probe) == 1) return host;
  struct addrinfo hints, *res = nullptr;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) return "";
  char buf[INET_ADDRSTRLEN];
  inet_ntop(AF_INET, &((struct sockaddr_in*)res->ai_addr)->sin_addr, buf,
            sizeof(buf));
  freeaddrinfo(res);
  return buf;
}

int connect_nb(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) { close(fd); return -1; }
  int r = connect(fd, (struct sockaddr*)&addr, sizeof(addr));
  if (r < 0 && errno != EINPROGRESS) { close(fd); return -1; }
  return fd;
}

// ---------------------------------------------------------------------------
// REST: HTTP/1.1 keepalive closed loop
// ---------------------------------------------------------------------------

struct RestConn {
  int fd = -1;
  enum { CONNECTING, WRITING, READING } state = CONNECTING;
  size_t wr_off = 0;
  std::vector<uint8_t> in;
  size_t scan_from = 0;   // resume point for the header-terminator scan
  ssize_t head_end = -1;  // offset just past \r\n\r\n once found
  long clen = -1;
  double t0 = 0;
  int backoff_until_idx = 0;  // reconnect pacing, in loop iterations
};

// Case-insensitive search for "content-length:" in [buf, buf+len); returns
// the value or -1.  Our servers emit "Content-Length" but RFC 7230 says
// field names are case-insensitive, so don't assume.
long find_clen(const uint8_t* buf, size_t len) {
  static const char* k = "content-length:";
  const size_t klen = 15;
  for (size_t i = 0; i + klen <= len; i++) {
    size_t j = 0;
    while (j < klen && (buf[i + j] | 0x20) == (uint8_t)k[j]) j++;
    if (j == klen) {
      long v = 0; size_t p = i + klen;
      while (p < len && buf[p] == ' ') p++;
      bool any = false;
      while (p < len && buf[p] >= '0' && buf[p] <= '9') {
        v = v * 10 + (buf[p] - '0'); p++; any = true;
      }
      return any ? v : -1;
    }
  }
  return -1;
}

int run_rest(const char* host, int port, int clients, double warmup_s,
             double duration_s, const std::vector<uint8_t>& request,
             Stats& stats) {
  int ep = epoll_create1(0);
  std::vector<RestConn> conns(clients);
  auto arm = [&](int i, uint32_t events, int op) {
    struct epoll_event ev; ev.events = events; ev.data.u32 = i;
    epoll_ctl(ep, op, conns[i].fd, &ev);
  };
  int closed_count = 0;  // slots with fd < 0 awaiting a reconnect attempt
  auto open_conn = [&](int i) -> bool {
    conns[i].fd = connect_nb(host, port);
    if (conns[i].fd < 0) { closed_count++; return false; }
    conns[i].state = RestConn::CONNECTING;
    conns[i].wr_off = 0;
    conns[i].in.clear();
    conns[i].scan_from = 0; conns[i].head_end = -1; conns[i].clen = -1;
    arm(i, EPOLLOUT, EPOLL_CTL_ADD);
    return true;
  };
  for (int i = 0; i < clients; i++) open_conn(i);

  const double t_start = now_s();
  const double t_measure = t_start + warmup_s;
  const double t_stop = t_measure + duration_s;
  bool measuring = warmup_s <= 0;
  std::vector<struct epoll_event> events(1024);
  std::vector<int> dead;  // conns to reopen this iteration

  auto fail_conn = [&](int i) {
    if (measuring && now_s() < t_stop) stats.failures++;
    if (conns[i].fd >= 0) { close(conns[i].fd); conns[i].fd = -1; }
    dead.push_back(i);
  };

  // start (or continue) writing the request on conn i; returns false on error
  auto pump_write = [&](int i) -> bool {
    RestConn& c = conns[i];
    while (c.wr_off < request.size()) {
      ssize_t n = write(c.fd, request.data() + c.wr_off,
                        request.size() - c.wr_off);
      if (n > 0) { c.wr_off += n; continue; }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        arm(i, EPOLLOUT | EPOLLIN, EPOLL_CTL_MOD);
        return true;
      }
      return false;
    }
    c.state = RestConn::READING;
    arm(i, EPOLLIN, EPOLL_CTL_MOD);
    return true;
  };

  while (true) {
    double t = now_s();
    if (!measuring && t >= t_measure) { stats.reset(); measuring = true; }
    if (t >= t_stop) break;
    int timeout_ms = (int)((t_stop - t) * 1000) + 1;
    int n = epoll_wait(ep, events.data(), events.size(), std::min(timeout_ms, 100));
    dead.clear();
    for (int e = 0; e < n; e++) {
      int i = events[e].data.u32;
      RestConn& c = conns[i];
      if (c.fd < 0) continue;
      if (events[e].events & (EPOLLERR | EPOLLHUP)) { fail_conn(i); continue; }
      if (c.state == RestConn::CONNECTING) {
        int err = 0; socklen_t el = sizeof(err);
        getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &el);
        if (err != 0) { fail_conn(i); continue; }
        c.state = RestConn::WRITING;
        c.t0 = now_s();
        if (!pump_write(i)) { fail_conn(i); continue; }
        continue;
      }
      if ((events[e].events & EPOLLOUT) && c.state == RestConn::WRITING) {
        if (!pump_write(i)) { fail_conn(i); continue; }
      }
      if (!(events[e].events & EPOLLIN)) continue;
      // READING (or residual EPOLLIN while writing — server never does that)
      char buf[65536];
      bool conn_dead = false;
      while (true) {
        ssize_t r = read(c.fd, buf, sizeof(buf));
        if (r > 0) {
          c.in.insert(c.in.end(), buf, buf + r);
          if (r == (ssize_t)sizeof(buf)) continue;
        } else if (r == 0) { conn_dead = true; }
        else if (errno != EAGAIN && errno != EWOULDBLOCK) { conn_dead = true; }
        break;
      }
      // parse as many complete responses as the buffer holds (the server
      // never pipelines unrequested data; normally exactly one)
      while (c.state == RestConn::READING) {
        if (c.head_end < 0) {
          if (c.in.size() >= 4) {
            const uint8_t* p = c.in.data();
            size_t from = c.scan_from > 3 ? c.scan_from - 3 : 0;
            for (size_t j = from; j + 4 <= c.in.size(); j++) {
              if (p[j] == '\r' && p[j+1] == '\n' && p[j+2] == '\r' &&
                  p[j+3] == '\n') { c.head_end = j + 4; break; }
            }
            c.scan_from = c.in.size();
          }
          if (c.head_end < 0) break;
          c.clen = find_clen(c.in.data(), c.head_end);
          if (c.clen < 0) c.clen = 0;
        }
        if (c.in.size() < (size_t)c.head_end + c.clen) break;
        // complete response
        bool ok = c.in.size() >= 12 && c.in[9] == '2';  // HTTP/1.1 2xx
        double tc = now_s();
        if (measuring) {
          if (ok) stats.lat_ms.push_back((float)((tc - c.t0) * 1e3));
          else stats.failures++;
        }
        size_t used = c.head_end + c.clen;
        c.in.erase(c.in.begin(), c.in.begin() + used);
        c.scan_from = 0; c.head_end = -1; c.clen = -1;
        // closed loop: fire the next request immediately
        c.state = RestConn::WRITING;
        c.wr_off = 0;
        c.t0 = tc;
        if (!pump_write(i)) { conn_dead = true; break; }
      }
      if (conn_dead) fail_conn(i);
    }
    for (int i : dead) open_conn(i);
    if (closed_count > 0) {
      // slots whose (re)connect itself failed: retry them each iteration
      closed_count = 0;
      for (int i = 0; i < clients; i++)
        if (conns[i].fd < 0) open_conn(i);
    }
  }
  for (auto& c : conns) if (c.fd >= 0) close(c.fd);
  close(ep);
  return 0;
}

// ---------------------------------------------------------------------------
// GRPC: HTTP/2 unary, multiplexed closed-loop clients
// ---------------------------------------------------------------------------

const uint8_t kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
enum { F_DATA = 0, F_HEADERS = 1, F_RST = 3, F_SETTINGS = 4, F_PING = 6,
       F_GOAWAY = 7, F_WINDOW_UPDATE = 8, F_CONTINUATION = 9 };
enum { FLAG_END_STREAM = 1, FLAG_ACK = 1, FLAG_END_HEADERS = 4 };

void put_frame_header(std::vector<uint8_t>& out, uint32_t len, uint8_t type,
                      uint8_t flags, uint32_t sid) {
  out.push_back((len >> 16) & 0xff);
  out.push_back((len >> 8) & 0xff);
  out.push_back(len & 0xff);
  out.push_back(type);
  out.push_back(flags);
  out.push_back((sid >> 24) & 0x7f);
  out.push_back((sid >> 16) & 0xff);
  out.push_back((sid >> 8) & 0xff);
  out.push_back(sid & 0xff);
}

struct Slot {  // one closed-loop client
  int conn = -1;
  uint32_t stream = 0;
  double t0 = 0;
  bool got_data = false;
  bool inflight = false;
};

struct GrpcConn {
  int fd = -1;
  bool connected = false;   // TCP established + preface sent
  std::vector<uint8_t> out;
  size_t out_off = 0;
  std::vector<uint8_t> in;
  size_t in_off = 0;        // parse cursor (compacted periodically)
  int64_t send_window = 65535;
  uint64_t recv_since_update = 0;
  uint32_t next_stream = 1;
  std::unordered_map<uint32_t, int> stream_slot;
  std::vector<int> parked;  // slots waiting for send window
  bool dead = false;
};

int run_grpc(const char* host, int port, int clients, int n_conns,
             double warmup_s, double duration_s,
             const std::vector<uint8_t>& header_block,
             const std::vector<uint8_t>& body, Stats& stats) {
  int ep = epoll_create1(0);
  std::vector<GrpcConn> conns(n_conns);
  std::vector<Slot> slots(clients);
  for (int s = 0; s < clients; s++) slots[s].conn = s % n_conns;

  auto arm = [&](int ci, uint32_t ev_mask, int op) {
    struct epoll_event ev; ev.events = ev_mask; ev.data.u32 = ci;
    epoll_ctl(ep, op, conns[ci].fd, &ev);
  };
  auto flush = [&](int ci) {
    GrpcConn& c = conns[ci];
    while (c.out_off < c.out.size()) {
      ssize_t n = write(c.fd, c.out.data() + c.out_off,
                        c.out.size() - c.out_off);
      if (n > 0) { c.out_off += n; continue; }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        arm(ci, EPOLLOUT | EPOLLIN, EPOLL_CTL_MOD);
        return;
      }
      c.dead = true;
      return;
    }
    if (c.out_off == c.out.size() && !c.out.empty()) {
      c.out.clear(); c.out_off = 0;
      arm(ci, EPOLLIN, EPOLL_CTL_MOD);
    }
  };
  auto open_conn = [&](int ci) -> bool {
    GrpcConn& c = conns[ci];
    std::vector<int> keep = std::move(c.parked);  // survive reconnects
    c = GrpcConn();
    c.parked = std::move(keep);
    c.fd = connect_nb(host, port);
    if (c.fd < 0) return false;
    // connection bootstrap: preface, SETTINGS (huge receive window), and a
    // connection WINDOW_UPDATE opening the conn-level receive window — the
    // same bootstrap runtime/grpcfast.py's client does
    c.out.insert(c.out.end(), kPreface, kPreface + sizeof(kPreface) - 1);
    put_frame_header(c.out, 12, F_SETTINGS, 0, 0);
    auto put_setting = [&](uint16_t k, uint32_t v) {
      c.out.push_back(k >> 8); c.out.push_back(k & 0xff);
      c.out.push_back(v >> 24); c.out.push_back((v >> 16) & 0xff);
      c.out.push_back((v >> 8) & 0xff); c.out.push_back(v & 0xff);
    };
    put_setting(0x4, 0x7fffffff);          // INITIAL_WINDOW_SIZE
    put_setting(0x3, 1u << 20);            // MAX_CONCURRENT_STREAMS
    put_frame_header(c.out, 4, F_WINDOW_UPDATE, 0, 0);
    uint32_t inc = 0x7fffffff - 65535;
    c.out.push_back(inc >> 24); c.out.push_back((inc >> 16) & 0xff);
    c.out.push_back((inc >> 8) & 0xff); c.out.push_back(inc & 0xff);
    arm(ci, EPOLLOUT | EPOLLIN, EPOLL_CTL_ADD);
    return true;
  };
  for (int ci = 0; ci < n_conns; ci++) {
    if (!open_conn(ci)) { fprintf(stderr, "loadgen: connect failed\n"); return 2; }
  }

  const double t_start = now_s();
  const double t_measure = t_start + warmup_s;
  const double t_stop = t_measure + duration_s;
  bool measuring = warmup_s <= 0;

  auto fire = [&](int si) {
    Slot& s = slots[si];
    GrpcConn& c = conns[s.conn];
    if (c.dead || !c.connected) { c.parked.push_back(si); return; }
    if (c.send_window < (int64_t)body.size()) { c.parked.push_back(si); return; }
    s.stream = c.next_stream;
    c.next_stream += 2;
    s.t0 = now_s();
    s.got_data = false;
    s.inflight = true;
    c.stream_slot[s.stream] = si;
    put_frame_header(c.out, header_block.size(), F_HEADERS, FLAG_END_HEADERS,
                     s.stream);
    c.out.insert(c.out.end(), header_block.begin(), header_block.end());
    put_frame_header(c.out, body.size(), F_DATA, FLAG_END_STREAM, s.stream);
    c.out.insert(c.out.end(), body.begin(), body.end());
    c.send_window -= body.size();
  };

  auto complete = [&](int ci, uint32_t sid, bool rst) {
    GrpcConn& c = conns[ci];
    auto it = c.stream_slot.find(sid);
    if (it == c.stream_slot.end()) return;
    int si = it->second;
    c.stream_slot.erase(it);
    Slot& s = slots[si];
    s.inflight = false;
    double t = now_s();
    if (measuring && t < t_stop) {
      if (!rst && s.got_data)
        stats.lat_ms.push_back((float)((t - s.t0) * 1e3));
      else
        stats.failures++;
    }
    if (t < t_stop) fire(si);
  };

  auto kill_conn = [&](int ci) {
    GrpcConn& c = conns[ci];
    if (c.fd >= 0) { close(c.fd); c.fd = -1; }
    std::vector<int> orphans;
    for (auto& kv : c.stream_slot) orphans.push_back(kv.second);
    c.stream_slot.clear();
    if (measuring) stats.failures += orphans.size();
    for (int si : orphans) {
      slots[si].inflight = false;
      c.parked.push_back(si);  // refired once the conn is back up
    }
    open_conn(ci);  // on failure the main loop retries each iteration
  };

  // process one complete frame at [p, p+9+len); returns frame length or -1
  auto handle = [&](int ci) {
    GrpcConn& c = conns[ci];
    while (true) {
      size_t avail = c.in.size() - c.in_off;
      if (avail < 9) break;
      const uint8_t* p = c.in.data() + c.in_off;
      uint32_t len = (p[0] << 16) | (p[1] << 8) | p[2];
      if (avail < 9 + len) break;
      uint8_t type = p[3], flags = p[4];
      uint32_t sid = ((p[5] & 0x7f) << 24) | (p[6] << 16) | (p[7] << 8) | p[8];
      const uint8_t* payload = p + 9;
      switch (type) {
        case F_DATA: {
          auto it = c.stream_slot.find(sid);
          if (it != c.stream_slot.end() && len > 0)
            slots[it->second].got_data = true;
          c.recv_since_update += len;
          if (c.recv_since_update >= (1u << 20)) {
            put_frame_header(c.out, 4, F_WINDOW_UPDATE, 0, 0);
            uint32_t inc = (uint32_t)c.recv_since_update;
            c.out.push_back(inc >> 24); c.out.push_back((inc >> 16) & 0xff);
            c.out.push_back((inc >> 8) & 0xff); c.out.push_back(inc & 0xff);
            c.recv_since_update = 0;
          }
          if (flags & FLAG_END_STREAM) complete(ci, sid, false);
          break;
        }
        case F_HEADERS:
        case F_CONTINUATION:
          if (flags & FLAG_END_STREAM) complete(ci, sid, false);
          break;
        case F_RST:
          complete(ci, sid, true);
          break;
        case F_SETTINGS:
          if (!(flags & FLAG_ACK)) {
            // Ack.  We ignore INITIAL_WINDOW_SIZE deltas: request bodies are
            // < 64 KiB and sent whole with END_STREAM, so per-stream windows
            // never bind; the server (grpcfast) advertises huge windows.
            put_frame_header(c.out, 0, F_SETTINGS, FLAG_ACK, 0);
            c.connected = true;
            std::vector<int> parked; parked.swap(c.parked);
            for (int si : parked) fire(si);
          }
          break;
        case F_PING:
          if (!(flags & FLAG_ACK)) {
            put_frame_header(c.out, 8, F_PING, FLAG_ACK, 0);
            c.out.insert(c.out.end(), payload, payload + 8);
          }
          break;
        case F_WINDOW_UPDATE: {
          uint32_t inc = ((payload[0] & 0x7f) << 24) | (payload[1] << 16) |
                         (payload[2] << 8) | payload[3];
          if (sid == 0) {
            c.send_window += inc;
            std::vector<int> parked; parked.swap(c.parked);
            for (int si : parked) fire(si);
          }
          break;
        }
        case F_GOAWAY:
          c.dead = true;
          break;
        default:
          break;  // PUSH_PROMISE / PRIORITY / unknown: ignore
      }
      c.in_off += 9 + len;
    }
    if (c.in_off > (1u << 16)) {
      c.in.erase(c.in.begin(), c.in.begin() + c.in_off);
      c.in_off = 0;
    }
  };

  std::vector<struct epoll_event> events(256);
  bool fired = false;
  while (true) {
    double t = now_s();
    if (!measuring && t >= t_measure) { stats.reset(); measuring = true; }
    if (t >= t_stop) break;
    for (int ci = 0; ci < n_conns; ci++)  // conns whose reconnect failed
      if (conns[ci].fd < 0) open_conn(ci);
    int n = epoll_wait(ep, events.data(), events.size(), 50);
    for (int e = 0; e < n; e++) {
      int ci = events[e].data.u32;
      GrpcConn& c = conns[ci];
      if (c.fd < 0) continue;
      if (events[e].events & (EPOLLERR | EPOLLHUP)) { kill_conn(ci); continue; }
      if (events[e].events & EPOLLIN) {
        char buf[65536];
        while (true) {
          ssize_t r = read(c.fd, buf, sizeof(buf));
          if (r > 0) {
            c.in.insert(c.in.end(), buf, buf + r);
            if (r == (ssize_t)sizeof(buf)) continue;
          } else if (r == 0) { c.dead = true; }
          else if (errno != EAGAIN && errno != EWOULDBLOCK) { c.dead = true; }
          break;
        }
        handle(ci);
      }
      if (c.dead) { kill_conn(ci); continue; }
      if (!fired && c.connected) {
        // first connection became ready: launch every client slot
        fired = true;
        for (int si = 0; si < clients; si++)
          if (!slots[si].inflight) fire(si);
      }
      flush(ci);
      if (c.dead) kill_conn(ci);
    }
  }
  for (auto& c : conns) if (c.fd >= 0) close(c.fd);
  close(ep);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* host = "127.0.0.1";
  int port = 8000, clients = 64, conns = -1;
  double duration = 10.0, warmup = 2.0;
  const char* api = "rest";
  const char* request_file = nullptr;
  const char* headers_file = nullptr;
  for (int i = 1; i < argc - 1; i++) {
    if (!strcmp(argv[i], "--host")) host = argv[++i];
    else if (!strcmp(argv[i], "--port")) port = atoi(argv[++i]);
    else if (!strcmp(argv[i], "--api")) api = argv[++i];
    else if (!strcmp(argv[i], "--clients")) clients = atoi(argv[++i]);
    else if (!strcmp(argv[i], "--conns")) conns = atoi(argv[++i]);
    else if (!strcmp(argv[i], "--duration")) duration = atof(argv[++i]);
    else if (!strcmp(argv[i], "--warmup")) warmup = atof(argv[++i]);
    else if (!strcmp(argv[i], "--request-file")) request_file = argv[++i];
    else if (!strcmp(argv[i], "--headers-file")) headers_file = argv[++i];
  }
  if (!request_file) { fprintf(stderr, "loadgen: --request-file required\n"); return 2; }
  std::string ip = resolve_ipv4(host);
  if (ip.empty()) { fprintf(stderr, "loadgen: cannot resolve %s\n", host); return 2; }
  host = ip.c_str();
  std::vector<uint8_t> request = read_file(request_file);

  Stats stats;
  stats.lat_ms.reserve(1 << 21);
  double t0 = now_s();
  int rc;
  if (!strcmp(api, "grpc")) {
    if (!headers_file) { fprintf(stderr, "loadgen: --headers-file required\n"); return 2; }
    std::vector<uint8_t> headers = read_file(headers_file);
    if (conns <= 0) conns = std::max(1, std::min(4, clients / 64));
    rc = run_grpc(host, port, clients, conns, warmup, duration, headers,
                  request, stats);
  } else {
    rc = run_rest(host, port, clients, warmup, duration, request, stats);
  }
  if (rc != 0) return rc;
  double wall = now_s() - t0 - warmup;

  std::vector<float>& v = stats.lat_ms;
  double p50 = pct(v, 50), p75 = pct(v, 75), p90 = pct(v, 90),
         p95 = pct(v, 95), p99 = pct(v, 99);
  printf(
      "{\"requests\": %zu, \"failures\": %llu, \"qps\": %.3f, "
      "\"clients\": %d, \"duration_s\": %.3f, \"p50_ms\": %.4f, "
      "\"p75_ms\": %.4f, \"p90_ms\": %.4f, \"p95_ms\": %.4f, "
      "\"p99_ms\": %.4f}\n",
      v.size(), (unsigned long long)stats.failures,
      v.size() / std::max(wall, 1e-9), clients, duration, p50, p75, p90, p95,
      p99);
  return 0;
}

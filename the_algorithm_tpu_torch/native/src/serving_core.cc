// Native serving core: epoll HTTP/1.1 front + size/deadline dynamic batcher.
//
// A copy of the JAX package's the_algorithm_tpu/native/src/serving_core.cc
// (the port imports nothing of that package), built by
// the_algorithm_tpu_torch/native beside tpurecsys.cc.
//
// The reference's model server is native (navi, Rust:
// navi/navi/src/{predict_service,batch,bootstrap}.rs): a socket front
// receives prediction requests, a batcher fires a batch when it reaches
// max_batch_size OR the oldest request has waited max_delay
// (batch.rs:116-200 `duration_past`), the runtime executes, and callbacks
// fan the rows back out to callers. The socket/batching/response plane
// lives here; the model is invoked by the Python drain loop
// (serving/native_front.py) that pulls ready batches via sc_next_batch and
// pushes results via sc_complete — mirroring navi's
// tokio-front/TF-C-API-runtime split.
//
// Wire protocol (kept binary like navi's tensors-over-gRPC, framed as HTTP):
//   POST /predict   body = u32 n_rows | f32 data[n_rows * feature_width]
//   -> 200          body = u32 n_rows | f32 data[n_rows * out_width]
//   GET /healthz    -> 200 "ok"
//   GET /stats      -> 200 JSON counters (requests, rows, batches, ...)
//
// Single epoll IO thread; sc_next_batch blocks the (external) model thread.
// A batch handed out and never completed keeps its requests unanswered, and
// /healthz keeps answering "ok": the drain loop's owner must watch it.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Conn {
  int fd = -1;
  std::string in;        // read buffer
  size_t need = 0;       // total bytes needed for current request (0 = headers incomplete)
  size_t header_end = 0; // offset just past \r\n\r\n
  bool is_predict = false, is_stats = false, is_health = false;
  bool awaiting = false; // request handed to batcher, response pending
  bool close_after = false;
};

struct PendingReq {
  int fd;
  uint32_t n_rows;
  std::vector<float> data; // n_rows * feature_width
  int64_t enqueued_us;
};

struct Batch {
  int64_t id;
  std::vector<PendingReq> reqs;
  uint32_t total_rows;
};

int64_t now_us() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000 + ts.tv_nsec / 1000;
}

struct Server {
  int port = 0;
  uint32_t feature_width = 0, out_width = 0;
  uint32_t max_batch_rows = 256;
  int64_t max_delay_us = 5000;

  int listen_fd = -1, epoll_fd = -1, wake_fd = -1;
  std::thread io_thread;
  std::atomic<bool> stop{false};

  std::mutex mu;
  std::condition_variable cv;
  std::deque<PendingReq> pending;
  uint32_t pending_rows = 0;
  std::unordered_map<int64_t, Batch> inflight; // batch_id -> batch
  int64_t next_batch_id = 1;

  std::unordered_map<int, std::unique_ptr<Conn>> conns;
  // responses to flush from the IO thread (completed batches land here)
  std::mutex out_mu;
  std::deque<std::pair<int, std::string>> outbox;

  // stats
  std::atomic<uint64_t> n_requests{0}, n_rows{0}, n_batches{0},
      n_http_errors{0}, n_bytes_in{0}, n_bytes_out{0}, n_closed{0},
      sum_batch_rows{0}, sum_queue_us{0};

  bool start();
  void run_io();
  void handle_readable(Conn* c);
  void try_parse(Conn* c);
  void respond(int fd, const std::string& payload);
  void wake() { uint64_t one = 1; ssize_t r = write(wake_fd, &one, 8); (void)r; }
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

bool Server::start() {
  listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (listen_fd < 0) return false;
  int one = 1;
  setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(uint16_t(port));
  if (bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
    return false;
  if (port == 0) { // report ephemeral port back
    socklen_t len = sizeof(addr);
    getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
  }
  if (listen(listen_fd, 128) < 0) return false;
  epoll_fd = epoll_create1(0);
  wake_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = listen_fd;
  epoll_ctl(epoll_fd, EPOLL_CTL_ADD, listen_fd, &ev);
  ev.data.fd = wake_fd;
  epoll_ctl(epoll_fd, EPOLL_CTL_ADD, wake_fd, &ev);
  io_thread = std::thread([this] { run_io(); });
  return true;
}

void Server::respond(int fd, const std::string& payload) {
  std::lock_guard<std::mutex> g(out_mu);
  outbox.emplace_back(fd, payload);
}

std::string http_frame(int code, const char* ctype, const std::string& body) {
  char head[256];
  const char* status = code == 200 ? "200 OK"
                     : code == 400 ? "400 Bad Request"
                     : code == 404 ? "404 Not Found"
                                   : "500 Internal Server Error";
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %s\r\nContent-Type: %s\r\n"
                   "Content-Length: %zu\r\nConnection: keep-alive\r\n\r\n",
                   status, ctype, body.size());
  return std::string(head, n) + body;
}

void Server::try_parse(Conn* c) {
  for (;;) {
    if (c->awaiting) return; // one request at a time per connection
    if (c->need == 0) {
      size_t he = c->in.find("\r\n\r\n");
      if (he == std::string::npos) return; // headers incomplete
      c->header_end = he + 4;
      // request line
      c->is_predict = c->in.rfind("POST /predict", 0) == 0;
      c->is_health = c->in.rfind("GET /healthz", 0) == 0;
      c->is_stats = c->in.rfind("GET /stats", 0) == 0;
      size_t clen = 0;
      size_t p = c->in.find("Content-Length:");
      if (p == std::string::npos) p = c->in.find("content-length:");
      if (p != std::string::npos && p < he) clen = strtoul(c->in.c_str() + p + 15, nullptr, 10);
      c->need = c->header_end + clen;
    }
    if (c->in.size() < c->need) return; // body incomplete

    std::string body = c->in.substr(c->header_end, c->need - c->header_end);
    c->in.erase(0, c->need);
    c->need = 0;

    if (c->is_health) {
      respond(c->fd, http_frame(200, "text/plain", "ok"));
      continue;
    }
    if (c->is_stats) {
      char buf[512];
      uint64_t nb = n_batches.load();
      snprintf(buf, sizeof(buf),
               "{\"requests\":%llu,\"rows\":%llu,\"batches\":%llu,"
               "\"avg_batch_rows\":%.2f,\"avg_queue_us\":%.1f,"
               "\"bytes_in\":%llu,\"bytes_out\":%llu,\"http_errors\":%llu}",
               (unsigned long long)n_requests.load(),
               (unsigned long long)n_rows.load(),
               (unsigned long long)nb,
               nb ? double(sum_batch_rows.load()) / nb : 0.0,
               n_requests.load() ? double(sum_queue_us.load()) / n_requests.load() : 0.0,
               (unsigned long long)n_bytes_in.load(),
               (unsigned long long)n_bytes_out.load(),
               (unsigned long long)n_http_errors.load());
      respond(c->fd, http_frame(200, "application/json", buf));
      continue;
    }
    if (!c->is_predict) {
      n_http_errors++;
      respond(c->fd, http_frame(404, "text/plain", "not found"));
      continue;
    }
    if (body.size() < 4) {
      n_http_errors++;
      respond(c->fd, http_frame(400, "text/plain", "short body"));
      continue;
    }
    uint32_t rows;
    memcpy(&rows, body.data(), 4);
    size_t want = 4 + size_t(rows) * feature_width * 4;
    if (rows == 0 || rows > max_batch_rows || body.size() != want) {
      n_http_errors++;
      respond(c->fd, http_frame(400, "text/plain", "bad row count / size"));
      continue;
    }
    PendingReq req;
    req.fd = c->fd;
    req.n_rows = rows;
    req.data.resize(size_t(rows) * feature_width);
    memcpy(req.data.data(), body.data() + 4, req.data.size() * 4);
    req.enqueued_us = now_us();
    c->awaiting = true;
    n_requests++;
    n_rows += rows;
    {
      std::lock_guard<std::mutex> g(mu);
      pending_rows += rows;
      pending.push_back(std::move(req));
    }
    cv.notify_one();
    return; // stop parsing until response sent
  }
}

void Server::handle_readable(Conn* c) {
  char buf[65536];
  for (;;) {
    ssize_t n = recv(c->fd, buf, sizeof(buf), 0);
    if (n > 0) {
      c->in.append(buf, size_t(n));
      n_bytes_in += uint64_t(n);
      if (c->in.size() > (size_t(max_batch_rows) * feature_width * 4 + 65536)) {
        c->close_after = true; // oversized garbage
        break;
      }
    } else if (n == 0) {
      c->close_after = true;
      break;
    } else {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      c->close_after = true;
      break;
    }
  }
  try_parse(c);
}

void Server::run_io() {
  epoll_event evs[64];
  for (;;) {
    if (stop.load()) break;
    int n = epoll_wait(epoll_fd, evs, 64, 50);
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == listen_fd) {
        for (;;) {
          int cfd = accept4(listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          auto c = std::make_unique<Conn>();
          c->fd = cfd;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
          conns[cfd] = std::move(c);
        }
      } else if (fd == wake_fd) {
        uint64_t junk;
        ssize_t r = read(wake_fd, &junk, 8);
        (void)r;
      } else {
        auto it = conns.find(fd);
        if (it != conns.end()) handle_readable(it->second.get());
      }
    }
    // flush outbox (responses produced by sc_complete or handlers)
    std::deque<std::pair<int, std::string>> out;
    {
      std::lock_guard<std::mutex> g(out_mu);
      out.swap(outbox);
    }
    for (auto& [fd, payload] : out) {
      auto it = conns.find(fd);
      if (it == conns.end()) continue;
      // blocking-ish send: responses are small relative to socket buffers
      size_t off = 0;
      bool fail = false;
      while (off < payload.size()) {
        ssize_t w = send(fd, payload.data() + off, payload.size() - off,
                         MSG_NOSIGNAL);
        if (w > 0) {
          off += size_t(w);
        } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          // wait for writability inline (rare; keeps state machine simple)
          struct timespec ts = {0, 1000000};
          nanosleep(&ts, nullptr);
        } else {
          fail = true;
          break;
        }
      }
      n_bytes_out += off;
      Conn* c = it->second.get();
      c->awaiting = false;
      if (fail || c->close_after) {
        epoll_ctl(epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
        close(fd);
        conns.erase(it);
        n_closed++;
      } else {
        try_parse(c); // pipelined next request may already be buffered
      }
    }
    // drop connections flagged closed with no pending response
    for (auto it = conns.begin(); it != conns.end();) {
      if (it->second->close_after && !it->second->awaiting) {
        epoll_ctl(epoll_fd, EPOLL_CTL_DEL, it->first, nullptr);
        close(it->first);
        n_closed++;
        it = conns.erase(it);
      } else {
        ++it;
      }
    }
  }
  for (auto& [fd, c] : conns) close(fd);
  conns.clear();
  close(listen_fd);
  close(epoll_fd);
  close(wake_fd);
}

}  // namespace

extern "C" {

void* sc_start(int port, uint32_t feature_width, uint32_t out_width,
               uint32_t max_batch_rows, int64_t max_delay_us) {
  auto* s = new Server();
  s->port = port;
  s->feature_width = feature_width;
  s->out_width = out_width;
  s->max_batch_rows = max_batch_rows;
  s->max_delay_us = max_delay_us;
  if (!s->start()) {
    delete s;
    return nullptr;
  }
  return s;
}

int sc_port(void* h) { return static_cast<Server*>(h)->port; }

// Blocks until a batch is ready (size/deadline) or timeout_us elapses.
// Copies up to max_batch_rows rows into out (caller-allocated
// [max_batch_rows * feature_width] floats). Returns n_rows (0 on timeout).
int sc_next_batch(void* h, float* out, int64_t* batch_id, int64_t timeout_us) {
  auto* s = static_cast<Server*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  int64_t deadline = now_us() + timeout_us;
  for (;;) {
    int64_t t = now_us();
    if (!s->pending.empty()) {
      bool full = s->pending_rows >= s->max_batch_rows;
      bool due = t - s->pending.front().enqueued_us >= s->max_delay_us;
      if (full || due) break;
    }
    if (t >= deadline) return 0;
    // sleep until the oldest request comes due, the caller deadline, or a
    // new arrival (cv notify)
    int64_t until = deadline;
    if (!s->pending.empty())
      until = std::min(until, s->pending.front().enqueued_us + s->max_delay_us);
    s->cv.wait_for(lk, std::chrono::microseconds(
                           std::max<int64_t>(until - now_us(), 1)));
  }
  Batch b;
  b.id = s->next_batch_id++;
  uint32_t rows = 0;
  int64_t t = now_us();
  while (!s->pending.empty()) {
    PendingReq& front = s->pending.front();
    if (rows + front.n_rows > s->max_batch_rows) break;
    memcpy(out + size_t(rows) * s->feature_width, front.data.data(),
           front.data.size() * 4);
    rows += front.n_rows;
    s->pending_rows -= front.n_rows;
    s->sum_queue_us += uint64_t(t - front.enqueued_us);
    b.reqs.push_back(std::move(front));
    s->pending.pop_front();
  }
  b.total_rows = rows;
  *batch_id = b.id;
  s->n_batches++;
  s->sum_batch_rows += rows;
  s->inflight[b.id] = std::move(b);
  return int(rows);
}

// results: [total_rows * out_width] floats, row order of the batch.
int sc_complete(void* h, int64_t batch_id, const float* results) {
  auto* s = static_cast<Server*>(h);
  Batch b;
  {
    std::lock_guard<std::mutex> g(s->mu);
    auto it = s->inflight.find(batch_id);
    if (it == s->inflight.end()) return -1;
    b = std::move(it->second);
    s->inflight.erase(it);
  }
  size_t row = 0;
  for (auto& req : b.reqs) {
    std::string body(4 + size_t(req.n_rows) * s->out_width * 4, '\0');
    memcpy(&body[0], &req.n_rows, 4);
    memcpy(&body[4], results + row * s->out_width,
           size_t(req.n_rows) * s->out_width * 4);
    row += req.n_rows;
    s->respond(req.fd, http_frame(200, "application/octet-stream", body));
  }
  s->wake();
  return 0;
}

void sc_stats(void* h, uint64_t* out /* [8] */) {
  auto* s = static_cast<Server*>(h);
  out[0] = s->n_requests.load();
  out[1] = s->n_rows.load();
  out[2] = s->n_batches.load();
  out[3] = s->sum_batch_rows.load();
  out[4] = s->sum_queue_us.load();
  out[5] = s->n_bytes_in.load();
  out[6] = s->n_bytes_out.load();
  out[7] = s->n_http_errors.load();
}

void sc_stop(void* h) {
  auto* s = static_cast<Server*>(h);
  s->stop.store(true);
  s->wake();
  s->cv.notify_all();
  if (s->io_thread.joinable()) s->io_thread.join();
  delete s;
}

}  // extern "C"

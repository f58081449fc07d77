// Epoll wire plane for the socket Van (core/tcp_van.py).
//
// Same plain-C ABI as tcpvan.cc — the Python layer (core/tcp_van.py) loads
// either backend interchangeably — but the thread model is inverted: ONE
// event-loop thread multiplexes every connection (listen fd + all conns +
// an eventfd for cross-thread wakeups) instead of tcpvan's accept thread +
// one recv thread per connection, which stops being a viable model at
// 10k+ connections (the serving plane's fan-in).
//
// Additions over the tcpvan ABI:
//   ps_van_send_vec(handle, conn, bufs[], lens[], n) — vectored send: the
//     12-byte wire header + a frame's segments (flat-frame header+meta,
//     then each value plane) go to writev() as an iovec, so a coalesced
//     bundle's member planes never concatenate host-side.  Returns 0 ok,
//     -1 dead conn, -2 write queue full (typed backpressure: the caller
//     counts writeq_full and lets the resender retransmit).
//
// Send path: callers run on arbitrary Python threads.  Under the conn's
// out-mutex, if nothing is queued we writev() straight from the caller's
// buffers (common case: zero staging copies); only the unsent TAIL of a
// partial write is copied into the bounded per-conn write queue and
// EPOLLOUT is armed for the loop thread to drain.  Once anything is queued
// the whole frame is queued (frames must not interleave on the wire).
//
// Recv path: a per-conn state machine reads the [u32 magic][u64 len]
// header, then malloc()s the payload ONCE and reads directly into it —
// ps_van_recv hands that same buffer to Python (no tcpvan-style memcpy on
// dequeue); Python decodes zero-copy views over it and frees it when the
// last view dies.  Inbound backpressure: when the shared frame queue hits
// max_queue the loop unregisters EPOLLIN on further-readable conns;
// ps_van_recv re-arms them (via eventfd) once the queue drains below half.
//
// Wire format is byte-identical to tcpvan: [u32 magic][u64 len][payload].

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>
#include <errno.h>
#include <fcntl.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50535641;  // "PSVA" — same wire as tcpvan
constexpr uint64_t kMaxFrame = 1ULL << 33;  // 8 GB sanity cap
constexpr size_t kMaxWriteQueue = 64ULL << 20;  // per-conn queued-byte bound
constexpr int kMaxIov = 64;  // syscall iovec cap; longer frames chunk

struct Frame {
  uint8_t* data = nullptr;  // malloc'd; ownership moves to ps_van_recv
  uint64_t len = 0;
  int conn_id = 0;
};

struct Conn {
  int fd = -1;
  int id = -1;
  std::atomic<bool> open{false};

  // ---- send side (out_mu): bounded queue of unsent bytes ----
  std::mutex out_mu;
  std::deque<std::vector<uint8_t>> outq;
  size_t outq_head_off = 0;  // consumed prefix of outq.front()
  size_t outq_bytes = 0;
  bool want_out = false;  // EPOLLOUT armed

  // ---- recv side (loop thread only): header/payload state machine ----
  uint8_t head_buf[12];
  size_t head_got = 0;
  uint8_t* body = nullptr;
  uint64_t body_len = 0, body_got = 0;
  // EPOLLIN dropped for inbound backpressure; atomic because arm() reads
  // it from sender threads while the loop thread flips it
  std::atomic<bool> paused{false};
};

struct VanImpl {
  int listen_fd = -1, epfd = -1, evfd = -1;
  int port = 0;
  std::thread loop_thread;
  std::atomic<bool> running{true};
  std::atomic<int> next_conn{0};

  std::mutex conns_mu;
  std::vector<std::unique_ptr<Conn>> conns;
  std::vector<Conn*> pending_reg;  // connects awaiting loop registration
  std::vector<int> pending_close;  // disconnects awaiting loop-side reap

  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Frame> queue;
  size_t max_queue = 4096;
  bool resume_needed = false;  // conns paused; re-arm when queue drains

  std::atomic<int64_t> bytes_sent{0}, bytes_recv{0};
  std::atomic<int64_t> writeq_full{0};
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  if (fl >= 0) fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void wake_loop(VanImpl* van) {
  uint64_t one = 1;
  ssize_t r = ::write(van->evfd, &one, 8);
  (void)r;
}

void arm(VanImpl* van, Conn* c, bool out) {
  epoll_event ev{};
  ev.events = (c->paused.load() ? 0u : static_cast<uint32_t>(EPOLLIN)) |
              (out ? static_cast<uint32_t>(EPOLLOUT) : 0u) | EPOLLRDHUP;
  ev.data.ptr = c;
  epoll_ctl(van->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// Queue the tail [done, total) of an iovec array (out_mu held).
void queue_tail(Conn* c, const iovec* iov, int n, size_t done) {
  for (int i = 0; i < n; ++i) {
    size_t len = iov[i].iov_len;
    if (done >= len) { done -= len; continue; }
    auto* base = static_cast<const uint8_t*>(iov[i].iov_base) + done;
    c->outq.emplace_back(base, base + (len - done));
    c->outq_bytes += len - done;
    done = 0;
  }
}

// Attempt a direct vectored write (out_mu held, outq empty).  Returns bytes
// written, or -1 on a fatal socket error.
ssize_t try_writev(Conn* c, const iovec* iov, int n, size_t total) {
  size_t done = 0;
  int idx = 0;
  iovec local[kMaxIov];
  while (done < total) {
    // skip fully-written segments, adjust the partially-written one
    size_t skip = done;
    int li = 0;
    for (int i = idx; i < n && li < kMaxIov; ++i) {
      size_t len = iov[i].iov_len;
      if (skip >= len) { skip -= len; idx = i + 1; continue; }
      local[li].iov_base = static_cast<uint8_t*>(iov[i].iov_base) + skip;
      local[li].iov_len = len - skip;
      skip = 0;
      ++li;
    }
    ssize_t w = ::writev(c->fd, local, li);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) return static_cast<ssize_t>(done);
      if (errno == EINTR) continue;
      return -1;
    }
    done += static_cast<size_t>(w);
    if (static_cast<size_t>(w) == 0) return static_cast<ssize_t>(done);
    // a short write means the socket buffer is full: stop, queue the rest
    if (done < total) {
      // recompute from 'done' on the next loop iteration only if the
      // kernel took the whole local batch; otherwise bail to the queue
      size_t batch = 0;
      for (int i = 0; i < li; ++i) batch += local[i].iov_len;
      if (static_cast<size_t>(w) < batch) return static_cast<ssize_t>(done);
    }
  }
  return static_cast<ssize_t>(done);
}

// Common send body: frame the payload segments and write/queue them.
int send_segments(VanImpl* van, int conn_id, const uint8_t* const* bufs,
                  const int64_t* lens, int nseg) {
  Conn* conn = nullptr;
  {
    std::lock_guard<std::mutex> lk(van->conns_mu);
    for (auto& c : van->conns)
      if (c->id == conn_id) { conn = c.get(); break; }
  }
  if (!conn || !conn->open.load()) return -1;

  uint64_t total = 0;
  for (int i = 0; i < nseg; ++i) total += static_cast<uint64_t>(lens[i]);
  uint8_t header[12];
  memcpy(header, &kMagic, 4);
  memcpy(header + 4, &total, 8);

  iovec iov[kMaxIov];
  int n = 0;
  iov[n].iov_base = header;
  iov[n].iov_len = 12;
  ++n;
  for (int i = 0; i < nseg; ++i) {
    if (lens[i] == 0) continue;
    if (n == kMaxIov) return -3;  // caller retries via single-buffer path
    iov[n].iov_base = const_cast<uint8_t*>(bufs[i]);
    iov[n].iov_len = static_cast<size_t>(lens[i]);
    ++n;
  }
  size_t wire = 12 + total;

  bool dead = false;
  int rc = 0;
  {
    // lock order: out_mu is a LEAF — never acquire conns_mu/q_mu under it
    // (the loop thread's reap path takes conns_mu -> out_mu)
    std::lock_guard<std::mutex> lk(conn->out_mu);
    if (!conn->open.load()) return -1;
    size_t done = 0;
    if (conn->outq.empty()) {
      ssize_t w = try_writev(conn, iov, n, wire);
      if (w < 0) {
        conn->open.store(false);
        dead = true;
      } else {
        done = static_cast<size_t>(w);
      }
    }
    if (!dead && done < wire) {
      // bounded queue: admit the whole frame or none (frames never split
      // ACROSS the admission decision — partial direct writes above are
      // already on the wire and their tail MUST queue regardless)
      if (done == 0 && conn->outq_bytes + wire > kMaxWriteQueue) {
        van->writeq_full.fetch_add(1);
        return -2;
      }
      queue_tail(conn, iov, n, done);
      if (!conn->want_out) {
        conn->want_out = true;
        arm(van, conn, true);
        wake_loop(van);
      }
    }
  }
  if (dead) {
    {
      std::lock_guard<std::mutex> clk(van->conns_mu);
      van->pending_close.push_back(conn->id);
    }
    wake_loop(van);
    return -1;
  }
  van->bytes_sent += static_cast<int64_t>(wire);
  return rc;
}

void push_frame(VanImpl* van, Frame&& f, bool* paused_any) {
  std::lock_guard<std::mutex> lk(van->q_mu);
  van->queue.push_back(std::move(f));
  if (van->queue.size() >= van->max_queue) {
    *paused_any = true;  // loop pauses EPOLLIN on the conns it services
    van->resume_needed = true;
  }
}

// Drain readable bytes on a conn (loop thread).  Returns false when the
// conn died (EOF / error / oversized frame).
bool service_read(VanImpl* van, Conn* c) {
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(van->q_mu);
      if (van->queue.size() >= van->max_queue) {
        // inbound backpressure: stop reading this conn until Python drains
        van->resume_needed = true;
        c->paused = true;
        std::lock_guard<std::mutex> olk(c->out_mu);
        arm(van, c, c->want_out);
        return true;
      }
    }
    if (c->head_got < 12) {
      ssize_t r = ::recv(c->fd, c->head_buf + c->head_got, 12 - c->head_got, 0);
      if (r == 0) return false;
      if (r < 0)
        return errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR;
      c->head_got += static_cast<size_t>(r);
      if (c->head_got < 12) return true;
      uint32_t magic;
      memcpy(&magic, c->head_buf, 4);
      memcpy(&c->body_len, c->head_buf + 4, 8);
      if (magic != kMagic || c->body_len > kMaxFrame) return false;
      c->body = static_cast<uint8_t*>(
          malloc(c->body_len ? c->body_len : 1));
      c->body_got = 0;
      if (!c->body) return false;
    }
    while (c->body_got < c->body_len) {
      ssize_t r = ::recv(c->fd, c->body + c->body_got,
                         c->body_len - c->body_got, 0);
      if (r == 0) return false;
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
          return true;
        return false;
      }
      c->body_got += static_cast<size_t>(r);
    }
    // complete frame: hand the malloc'd buffer to the shared queue
    van->bytes_recv += static_cast<int64_t>(c->body_len) + 12;
    Frame f;
    f.data = c->body;
    f.len = c->body_len;
    f.conn_id = c->id;
    c->body = nullptr;
    c->head_got = 0;
    bool paused = false;
    push_frame(van, std::move(f), &paused);
    van->q_cv.notify_all();
  }
}

// Flush the queued tail on EPOLLOUT (loop thread).
bool service_write(VanImpl* van, Conn* c) {
  std::lock_guard<std::mutex> lk(c->out_mu);
  while (!c->outq.empty()) {
    iovec iov[kMaxIov];
    int n = 0;
    size_t off = c->outq_head_off;
    for (auto& chunk : c->outq) {
      if (n == kMaxIov) break;
      iov[n].iov_base = chunk.data() + off;
      iov[n].iov_len = chunk.size() - off;
      off = 0;
      ++n;
    }
    ssize_t w = ::writev(c->fd, iov, n);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
        return true;
      return false;
    }
    size_t left = static_cast<size_t>(w);
    c->outq_bytes -= left;
    while (left > 0 && !c->outq.empty()) {
      size_t avail = c->outq.front().size() - c->outq_head_off;
      if (left >= avail) {
        left -= avail;
        c->outq.pop_front();
        c->outq_head_off = 0;
      } else {
        c->outq_head_off += left;
        left = 0;
      }
    }
  }
  c->want_out = false;
  arm(van, c, false);
  return true;
}

void reap_conn(VanImpl* van, Conn* c) {
  if (c->fd < 0) return;  // idempotent: already reaped
  epoll_ctl(van->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  ::close(c->fd);
  c->fd = -1;
  c->open.store(false);
  free(c->body);
  c->body = nullptr;
  {
    std::lock_guard<std::mutex> lk(c->out_mu);
    c->outq.clear();
    c->outq_bytes = 0;
  }
  Frame f;
  f.conn_id = -(c->id + 2);  // same closed-conn sentinel as tcpvan
  {
    std::lock_guard<std::mutex> lk(van->q_mu);
    van->queue.push_back(std::move(f));
  }
  van->q_cv.notify_all();
}

Conn* add_conn(VanImpl* van, int fd, bool from_loop) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  set_nonblock(fd);
  auto conn = std::make_unique<Conn>();
  conn->fd = fd;
  conn->id = van->next_conn++;
  conn->open.store(true);
  Conn* raw = conn.get();
  {
    std::lock_guard<std::mutex> lk(van->conns_mu);
    if (!van->running.load()) {
      ::close(fd);
      return nullptr;
    }
    van->conns.push_back(std::move(conn));
    if (from_loop) {
      epoll_event ev{};
      ev.events = EPOLLIN | EPOLLRDHUP;
      ev.data.ptr = raw;
      epoll_ctl(van->epfd, EPOLL_CTL_ADD, fd, &ev);
    } else {
      van->pending_reg.push_back(raw);
    }
  }
  if (!from_loop) wake_loop(van);
  return raw;
}

void event_loop(VanImpl* van) {
  constexpr int kMaxEvents = 256;
  epoll_event events[kMaxEvents];
  while (van->running.load()) {
    int n = epoll_wait(van->epfd, events, kMaxEvents, 200);
    if (!van->running.load()) break;
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    // cross-thread work: register fresh connects, reap dead conns, resume
    // paused conns once Python drained the queue
    {
      std::lock_guard<std::mutex> lk(van->conns_mu);
      for (Conn* c : van->pending_reg) {
        if (c->fd < 0) continue;
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLRDHUP;
        {
          std::lock_guard<std::mutex> olk(c->out_mu);
          if (c->want_out) ev.events |= EPOLLOUT;
        }
        ev.data.ptr = c;
        epoll_ctl(van->epfd, EPOLL_CTL_ADD, c->fd, &ev);
      }
      van->pending_reg.clear();
      for (int id : van->pending_close) {
        for (auto& c : van->conns)
          if (c->id == id && c->fd >= 0) reap_conn(van, c.get());
      }
      van->pending_close.clear();
    }
    bool resume = false;
    {
      std::lock_guard<std::mutex> lk(van->q_mu);
      if (van->resume_needed && van->queue.size() < van->max_queue / 2) {
        van->resume_needed = false;
        resume = true;
      }
    }
    if (resume) {
      std::lock_guard<std::mutex> lk(van->conns_mu);
      for (auto& c : van->conns) {
        if (c->paused && c->fd >= 0) {
          c->paused = false;
          std::lock_guard<std::mutex> olk(c->out_mu);
          arm(van, c.get(), c->want_out);
        }
      }
    }
    for (int i = 0; i < n; ++i) {
      if (events[i].data.ptr == nullptr) {  // eventfd tick: drain it
        uint64_t v;
        ssize_t r = ::read(van->evfd, &v, 8);
        (void)r;
        continue;
      }
      if (events[i].data.ptr == van) {  // listen fd
        for (;;) {
          int fd = ::accept(van->listen_fd, nullptr, nullptr);
          if (fd < 0) break;
          add_conn(van, fd, /*from_loop=*/true);
        }
        continue;
      }
      auto* c = static_cast<Conn*>(events[i].data.ptr);
      if (c->fd < 0) continue;  // reaped earlier this batch
      bool alive = true;
      if (events[i].events & EPOLLOUT) alive = service_write(van, c);
      if (alive && (events[i].events & (EPOLLIN | EPOLLRDHUP | EPOLLHUP |
                                        EPOLLERR)))
        alive = service_read(van, c);
      if (!alive) {
        std::lock_guard<std::mutex> lk(van->conns_mu);
        reap_conn(van, c);
      }
    }
  }
}

}  // namespace

extern "C" {

void* ps_van_new(const char* host, int port, int* actual_port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = host && *host ? inet_addr(host) : INADDR_ANY;
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 1024) < 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  set_nonblock(fd);
  auto* van = new VanImpl();
  van->listen_fd = fd;
  van->port = ntohs(addr.sin_port);
  van->epfd = epoll_create1(0);
  van->evfd = eventfd(0, EFD_NONBLOCK);
  if (van->epfd < 0 || van->evfd < 0) {
    ::close(fd);
    if (van->epfd >= 0) ::close(van->epfd);
    if (van->evfd >= 0) ::close(van->evfd);
    delete van;
    return nullptr;
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.ptr = van;  // listen marker
  epoll_ctl(van->epfd, EPOLL_CTL_ADD, fd, &ev);
  ev.events = EPOLLIN;
  ev.data.ptr = nullptr;  // eventfd marker
  epoll_ctl(van->epfd, EPOLL_CTL_ADD, van->evfd, &ev);
  if (actual_port) *actual_port = van->port;
  van->loop_thread = std::thread(event_loop, van);
  return van;
}

int ps_van_connect(void* vvan, const char* host, int port) {
  auto* van = static_cast<VanImpl*>(vvan);
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = inet_addr(host);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  Conn* c = add_conn(van, fd, /*from_loop=*/false);
  return c ? c->id : -1;
}

int ps_van_send(void* vvan, int conn_id, const uint8_t* data, int64_t len) {
  const uint8_t* bufs[1] = {data};
  int64_t lens[1] = {len};
  int rc = send_segments(static_cast<VanImpl*>(vvan), conn_id, bufs, lens, 1);
  return rc == -2 ? -1 : rc;  // legacy contract: only 0 / -1
}

// Vectored send: 0 ok, -1 dead conn, -2 write queue full (typed
// backpressure), -3 too many segments (caller joins and retries).
int ps_van_send_vec(void* vvan, int conn_id, const uint8_t* const* bufs,
                    const int64_t* lens, int nseg) {
  return send_segments(static_cast<VanImpl*>(vvan), conn_id, bufs, lens, nseg);
}

int64_t ps_van_recv(void* vvan, double timeout_s, uint8_t** out_data,
                    int* out_conn) {
  auto* van = static_cast<VanImpl*>(vvan);
  Frame f;
  bool resume;
  {
    std::unique_lock<std::mutex> lk(van->q_mu);
    bool ok = van->q_cv.wait_for(
        lk, std::chrono::duration<double>(timeout_s),
        [van] { return !van->queue.empty() || !van->running.load(); });
    if (!van->running.load() && van->queue.empty()) return -3;
    if (!ok) return -1;
    f = std::move(van->queue.front());
    van->queue.pop_front();
    resume = van->resume_needed && van->queue.size() < van->max_queue / 2;
  }
  if (resume) wake_loop(van);  // loop re-arms paused conns
  if (f.conn_id < 0) {
    if (out_conn) *out_conn = -f.conn_id - 2;
    return -2;
  }
  if (out_conn) *out_conn = f.conn_id;
  // ZERO-COPY handoff: the recv state machine read straight into this
  // malloc'd buffer; Python decodes views over it and ps_van_free()s it.
  *out_data = f.data ? f.data : static_cast<uint8_t*>(malloc(1));
  return static_cast<int64_t>(f.len);
}

void ps_van_free(uint8_t* buf) { free(buf); }

void ps_van_disconnect(void* vvan, int conn_id) {
  auto* van = static_cast<VanImpl*>(vvan);
  {
    std::lock_guard<std::mutex> lk(van->conns_mu);
    bool found = false;
    for (auto& c : van->conns)
      if (c->id == conn_id && c->fd >= 0) { found = true; break; }
    if (!found) return;
    van->pending_close.push_back(conn_id);
  }
  wake_loop(van);
}

int64_t ps_van_bytes_sent(void* vvan) {
  return static_cast<VanImpl*>(vvan)->bytes_sent.load();
}
int64_t ps_van_bytes_recv(void* vvan) {
  return static_cast<VanImpl*>(vvan)->bytes_recv.load();
}
int64_t ps_van_writeq_full(void* vvan) {
  return static_cast<VanImpl*>(vvan)->writeq_full.load();
}
int ps_van_port(void* vvan) { return static_cast<VanImpl*>(vvan)->port; }

void ps_van_close(void* vvan) {
  auto* van = static_cast<VanImpl*>(vvan);
  van->running.store(false);
  wake_loop(van);
  if (van->loop_thread.joinable()) van->loop_thread.join();
  ::close(van->listen_fd);
  {
    std::lock_guard<std::mutex> lk(van->conns_mu);
    for (auto& c : van->conns) {
      if (c->fd >= 0) ::close(c->fd);
      free(c->body);
    }
  }
  {
    std::lock_guard<std::mutex> lk(van->q_mu);
    for (auto& f : van->queue) free(f.data);
    van->queue.clear();
  }
  van->q_cv.notify_all();
  ::close(van->epfd);
  ::close(van->evfd);
  delete van;
}

}  // extern "C"

// Native TCP transport core for the socket Van (core/tcp_van.py), the
// thread-per-connection backend.
//
// The reference's Van owns ZeroMQ sockets, a node table, and a receive
// thread (``src/system/van.h/.cc``).  This file is that wire:
// length-prefixed frames over TCP, one recv thread per connection, a shared
// inbound frame queue drained by the Python dispatch thread.
//
// Scope split: C++ owns sockets, framing, threads, and the queue (the
// perf-critical, syscall-heavy part); Python owns routing, serialization,
// and handlers.  ABI is plain C for ctypes.
//
// Frame format on the wire: [u32 magic][u64 payload_len][payload bytes].

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

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

constexpr uint32_t kMagic = 0x50535641;  // "PSVA"

struct Frame {
  std::vector<uint8_t> data;
  int conn_id;
};

struct Conn {
  int fd = -1;
  int id = -1;
  std::thread recv_thread;
  std::mutex send_mu;
  std::atomic<bool> open{false};
};

struct VanImpl {
  int listen_fd = -1;
  int port = 0;
  std::thread accept_thread;
  std::atomic<bool> running{true};
  std::atomic<int> next_conn{0};

  std::mutex conns_mu;
  std::vector<std::unique_ptr<Conn>> conns;

  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Frame> queue;
  // Backpressure bound: recv threads park when the Python side falls this
  // many frames behind, instead of buffering unboundedly.
  size_t max_queue = 4096;

  std::atomic<int64_t> bytes_sent{0}, bytes_recv{0};
};

bool read_full(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void recv_loop(VanImpl* van, Conn* conn) {
  while (van->running.load() && conn->open.load()) {
    uint32_t magic;
    uint64_t len;
    if (!read_full(conn->fd, &magic, 4) || magic != kMagic) break;
    if (!read_full(conn->fd, &len, 8)) break;
    if (len > (1ULL << 33)) break;  // 8 GB sanity cap: corrupt stream
    Frame f;
    f.conn_id = conn->id;
    f.data.resize(len);
    if (len && !read_full(conn->fd, f.data.data(), len)) break;
    van->bytes_recv += static_cast<int64_t>(len) + 12;
    {
      std::unique_lock<std::mutex> lk(van->q_mu);
      van->q_cv.wait(lk, [van, conn] {
        return van->queue.size() < van->max_queue || !van->running.load() ||
               !conn->open.load();
      });
      if (!van->running.load() || !conn->open.load()) break;
      van->queue.push_back(std::move(f));
    }
    van->q_cv.notify_all();
  }
  conn->open.store(false);
  // signal disconnect to the drainer with an empty sentinel frame
  {
    std::lock_guard<std::mutex> lk(van->q_mu);
    Frame f;
    f.conn_id = -(conn->id + 2);  // negative = conn closed marker
    van->queue.push_back(std::move(f));
  }
  van->q_cv.notify_all();
}

Conn* add_conn(VanImpl* van, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto conn = std::make_unique<Conn>();
  conn->fd = fd;
  conn->id = van->next_conn++;
  conn->open.store(true);
  Conn* raw = conn.get();
  // Everything (including the thread start) happens under conns_mu so
  // ps_van_close can never observe a half-constructed entry, and a conn
  // accepted concurrently with close() gets shut down here instead of
  // being missed by close()'s shutdown sweep (which may already have run).
  std::lock_guard<std::mutex> lk(van->conns_mu);
  if (!van->running.load()) {
    raw->open.store(false);
    ::shutdown(fd, SHUT_RDWR);
  }
  raw->recv_thread = std::thread(recv_loop, van, raw);
  van->conns.push_back(std::move(conn));
  return raw;
}

void accept_loop(VanImpl* van) {
  while (van->running.load()) {
    sockaddr_in addr{};
    socklen_t alen = sizeof(addr);
    int fd = ::accept(van->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    if (fd < 0) {
      if (!van->running.load()) return;
      continue;
    }
    add_conn(van, fd);
  }
}

Conn* get_conn(VanImpl* van, int conn_id) {
  std::lock_guard<std::mutex> lk(van->conns_mu);
  for (auto& c : van->conns)
    if (c->id == conn_id) return c.get();
  return nullptr;
}

}  // namespace

extern "C" {

// Create a Van bound to host:port (port 0 = ephemeral). Returns handle or
// nullptr; *actual_port receives the bound port.
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
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  auto* van = new VanImpl();
  van->listen_fd = fd;
  van->port = ntohs(addr.sin_port);
  if (actual_port) *actual_port = van->port;
  van->accept_thread = std::thread(accept_loop, van);
  return van;
}

// Connect to a peer. Returns conn id >= 0, or -1 on failure.
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
  return add_conn(van, fd)->id;
}

// Send one frame on a connection. Returns 0 ok, -1 failure.
int ps_van_send(void* vvan, int conn_id, const uint8_t* data, int64_t len) {
  auto* van = static_cast<VanImpl*>(vvan);
  Conn* conn = get_conn(van, conn_id);
  if (!conn || !conn->open.load()) return -1;
  std::lock_guard<std::mutex> lk(conn->send_mu);
  uint64_t ulen = static_cast<uint64_t>(len);
  if (!write_full(conn->fd, &kMagic, 4) || !write_full(conn->fd, &ulen, 8) ||
      (len && !write_full(conn->fd, data, ulen))) {
    conn->open.store(false);
    return -1;
  }
  van->bytes_sent += len + 12;
  return 0;
}

// Wait for an inbound frame. Returns payload length (>= 0) and fills
// *out_data (malloc'd, free with ps_van_free) and *out_conn;
// -1 on timeout; -2 when a connection closed (out_conn = its id);
// -3 when the van is shut down.
int64_t ps_van_recv(void* vvan, double timeout_s, uint8_t** out_data,
                    int* out_conn) {
  auto* van = static_cast<VanImpl*>(vvan);
  std::unique_lock<std::mutex> lk(van->q_mu);
  bool ok = van->q_cv.wait_for(
      lk, std::chrono::duration<double>(timeout_s),
      [van] { return !van->queue.empty() || !van->running.load(); });
  if (!van->running.load() && van->queue.empty()) return -3;
  if (!ok) return -1;
  Frame f = std::move(van->queue.front());
  van->queue.pop_front();
  lk.unlock();
  van->q_cv.notify_all();  // wake parked recv threads (backpressure)
  if (f.conn_id < 0) {
    if (out_conn) *out_conn = -f.conn_id - 2;
    return -2;
  }
  if (out_conn) *out_conn = f.conn_id;
  auto* buf = static_cast<uint8_t*>(malloc(f.data.size() ? f.data.size() : 1));
  if (!f.data.empty()) memcpy(buf, f.data.data(), f.data.size());
  *out_data = buf;
  return static_cast<int64_t>(f.data.size());
}

void ps_van_free(uint8_t* buf) { free(buf); }

// Close one connection (fault injection / peer removal / failed-send reap).
// Fully reclaims the fd and recv thread; the Conn object itself stays in
// `conns` as a tombstone so raw pointers held by concurrent ps_van_send
// calls remain valid (send fails via open == false).
void ps_van_disconnect(void* vvan, int conn_id) {
  auto* van = static_cast<VanImpl*>(vvan);
  std::lock_guard<std::mutex> reap_lk(van->conns_mu);
  Conn* conn = nullptr;
  for (auto& c : van->conns)
    if (c->id == conn_id) { conn = c.get(); break; }
  if (!conn) return;
  if (conn->open.exchange(false)) ::shutdown(conn->fd, SHUT_RDWR);
  // Order the open=false store with the recv thread's backpressure predicate:
  // without holding q_mu between the store and the notify, the thread can
  // evaluate its predicate (open still true), lose the notify, then park
  // forever — and the join() below would wedge every caller on conns_mu.
  { std::lock_guard<std::mutex> qlk(van->q_mu); }
  van->q_cv.notify_all();  // wake its recv thread if parked on backpressure
  if (conn->recv_thread.joinable()) conn->recv_thread.join();
  std::lock_guard<std::mutex> send_lk(conn->send_mu);  // no in-flight writer
  if (conn->fd >= 0) {
    ::close(conn->fd);
    conn->fd = -1;
  }
}

int64_t ps_van_bytes_sent(void* vvan) {
  return static_cast<VanImpl*>(vvan)->bytes_sent.load();
}
int64_t ps_van_bytes_recv(void* vvan) {
  return static_cast<VanImpl*>(vvan)->bytes_recv.load();
}
int ps_van_port(void* vvan) { return static_cast<VanImpl*>(vvan)->port; }

void ps_van_close(void* vvan) {
  auto* van = static_cast<VanImpl*>(vvan);
  van->running.store(false);
  ::shutdown(van->listen_fd, SHUT_RDWR);
  ::close(van->listen_fd);
  {
    std::lock_guard<std::mutex> lk(van->conns_mu);
    for (auto& c : van->conns)
      if (c->open.exchange(false)) ::shutdown(c->fd, SHUT_RDWR);
  }
  // Same lost-wakeup ordering as ps_van_disconnect: a recv thread parked on
  // the backpressure predicate must observe running/open flipped before the
  // notify, or the joins below hang.
  { std::lock_guard<std::mutex> qlk(van->q_mu); }
  van->q_cv.notify_all();
  if (van->accept_thread.joinable()) van->accept_thread.join();
  {
    std::lock_guard<std::mutex> lk(van->conns_mu);
    for (auto& c : van->conns) {
      if (c->recv_thread.joinable()) c->recv_thread.join();
      if (c->fd >= 0) ::close(c->fd);  // -1 = already reaped by disconnect
    }
  }
  delete van;
}

}  // extern "C"

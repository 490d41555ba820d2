// TCPStore — native host-side bootstrap KV store (the port's copy of
// paddle_tpu/core/native/tcp_store.cpp).
//
// Reference: paddle/phi/core/distributed/store/tcp_store.h:121 (+
// tcp_utils.cc, socket.cpp): rank-0 hosts a TCP master; every rank can
// set/get/add/wait keys; barriers are add+wait. The reference uses it to
// bootstrap NCCL communicators; here it backs the launcher, elastic membership, and feeds the collective watchdog
// (comm_task_manager.cc analog below).
//
// Protocol (length-prefixed, all ints little-endian int64):
//   request : op(1 byte) keylen keybytes [vallen valbytes | delta | timeout]
//   response: status(1 byte) [vallen valbytes | value]
// Ops: 1=SET 2=GET(blocking, timeout ms) 3=ADD 4=CHECK 5=DELETE
//
// Built as a shared library; Python binds via ctypes
// (paddle_tpu_torch/distributed/tcp_store.py).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Server {
  int listen_fd = -1;
  std::thread accept_thread;
  std::atomic<bool> running{false};
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::vector<uint8_t>> kv;
  std::map<std::string, int64_t> counters;
  std::vector<std::thread> workers;
  std::mutex fds_mu;
  std::vector<int> client_fds;  // shut down on stop so recv() unblocks
};

bool read_full(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd, p + got, n - got, 0);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = ::send(fd, p + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return false;
    sent += static_cast<size_t>(r);
  }
  return true;
}

bool read_i64(int fd, int64_t* v) { return read_full(fd, v, 8); }
bool write_i64(int fd, int64_t v) { return write_full(fd, &v, 8); }

void serve_client(Server* s, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  {
    std::lock_guard<std::mutex> lk(s->fds_mu);
    s->client_fds.push_back(fd);
  }
  while (s->running.load()) {
    uint8_t op;
    if (!read_full(fd, &op, 1)) break;
    int64_t keylen;
    if (!read_i64(fd, &keylen) || keylen < 0 || keylen > (1 << 20)) break;
    std::string key(static_cast<size_t>(keylen), '\0');
    if (!read_full(fd, key.data(), key.size())) break;

    if (op == 1) {  // SET
      int64_t vallen;
      if (!read_i64(fd, &vallen) || vallen < 0 || vallen > (64 << 20)) break;
      std::vector<uint8_t> val(static_cast<size_t>(vallen));
      if (!read_full(fd, val.data(), val.size())) break;
      {
        std::lock_guard<std::mutex> lk(s->mu);
        s->kv[key] = std::move(val);
      }
      s->cv.notify_all();
      uint8_t ok = 0;
      if (!write_full(fd, &ok, 1)) break;
    } else if (op == 2) {  // GET (blocking up to timeout ms)
      int64_t timeout_ms;
      if (!read_i64(fd, &timeout_ms)) break;
      std::vector<uint8_t> out;
      bool found = false;
      {
        std::unique_lock<std::mutex> lk(s->mu);
        auto pred = [&] { return s->kv.count(key) > 0 || !s->running; };
        if (timeout_ms < 0) {
          s->cv.wait(lk, pred);
        } else {
          s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
        }
        auto it = s->kv.find(key);
        if (it != s->kv.end()) {
          out = it->second;
          found = true;
        }
      }
      uint8_t status = found ? 0 : 1;
      if (!write_full(fd, &status, 1)) break;
      if (found) {
        if (!write_i64(fd, static_cast<int64_t>(out.size()))) break;
        if (!write_full(fd, out.data(), out.size())) break;
      }
    } else if (op == 3) {  // ADD (atomic counter)
      int64_t delta;
      if (!read_i64(fd, &delta)) break;
      int64_t now;
      {
        std::lock_guard<std::mutex> lk(s->mu);
        now = (s->counters[key] += delta);
        // mirror the counter into kv so WAIT/GET can see it
        std::string as_str = std::to_string(now);
        s->kv[key].assign(as_str.begin(), as_str.end());
      }
      s->cv.notify_all();
      uint8_t ok = 0;
      if (!write_full(fd, &ok, 1)) break;
      if (!write_i64(fd, now)) break;
    } else if (op == 4) {  // CHECK (non-blocking existence)
      uint8_t status;
      {
        std::lock_guard<std::mutex> lk(s->mu);
        status = s->kv.count(key) ? 0 : 1;
      }
      if (!write_full(fd, &status, 1)) break;
    } else if (op == 5) {  // DELETE
      {
        std::lock_guard<std::mutex> lk(s->mu);
        s->kv.erase(key);
        s->counters.erase(key);
      }
      uint8_t ok = 0;
      if (!write_full(fd, &ok, 1)) break;
    } else {
      break;
    }
  }
  {
    // deregister before closing so server_stop never shuts down a reused fd
    std::lock_guard<std::mutex> lk(s->fds_mu);
    for (auto it = s->client_fds.begin(); it != s->client_fds.end(); ++it) {
      if (*it == fd) {
        s->client_fds.erase(it);
        break;
      }
    }
  }
  ::close(fd);
}

struct Client {
  int fd = -1;
  std::mutex mu;  // one request/response in flight at a time
};

}  // namespace

extern "C" {

// ---- server ----
void* pd_store_server_start(int port) {
  auto* s = new Server();
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(s->listen_fd, 128) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  s->running = true;
  s->accept_thread = std::thread([s] {
    while (s->running.load()) {
      int fd = ::accept(s->listen_fd, nullptr, nullptr);
      if (fd < 0) break;
      s->workers.emplace_back(serve_client, s, fd);
    }
  });
  return s;
}

void pd_store_server_stop(void* handle) {
  auto* s = static_cast<Server*>(handle);
  if (!s) return;
  s->running = false;
  s->cv.notify_all();
  {
    std::lock_guard<std::mutex> lk(s->fds_mu);
    for (int fd : s->client_fds) ::shutdown(fd, SHUT_RDWR);
  }
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  for (auto& t : s->workers)
    if (t.joinable()) t.join();
  delete s;
}

// ---- client ----
void* pd_store_client_connect(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    // not an IPv4 literal: resolve the hostname (reference tcp_utils.cc
    // resolves via getaddrinfo too)
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (::getaddrinfo(host, nullptr, &hints, &res) != 0 || res == nullptr) {
      ::close(fd);
      return nullptr;
    }
    addr.sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
    ::freeaddrinfo(res);
  }
  // retry-connect loop (master may start slightly later — reference
  // tcp_utils.cc connect-with-retry behavior)
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
         0) {
    if (std::chrono::steady_clock::now() > deadline) {
      ::close(fd);
      return nullptr;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    ::close(fd);
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client();
  c->fd = fd;
  return c;
}

void pd_store_client_close(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (!c) return;
  ::close(c->fd);
  delete c;
}

int pd_store_set(void* handle, const char* key, const uint8_t* val,
                 int64_t vallen) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  uint8_t op = 1;
  int64_t keylen = static_cast<int64_t>(strlen(key));
  if (!write_full(c->fd, &op, 1) || !write_i64(c->fd, keylen) ||
      !write_full(c->fd, key, keylen) || !write_i64(c->fd, vallen) ||
      !write_full(c->fd, val, vallen))
    return -1;
  uint8_t status;
  return read_full(c->fd, &status, 1) ? status : -1;
}

// returns value length (>=0) into out (caller buffer of cap bytes);
// -1 timeout/missing, -2 io error, -3 buffer too small
int64_t pd_store_get(void* handle, const char* key, int64_t timeout_ms,
                     uint8_t* out, int64_t cap) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  uint8_t op = 2;
  int64_t keylen = static_cast<int64_t>(strlen(key));
  if (!write_full(c->fd, &op, 1) || !write_i64(c->fd, keylen) ||
      !write_full(c->fd, key, keylen) || !write_i64(c->fd, timeout_ms))
    return -2;
  uint8_t status;
  if (!read_full(c->fd, &status, 1)) return -2;
  if (status != 0) return -1;
  int64_t vallen;
  if (!read_i64(c->fd, &vallen)) return -2;
  if (vallen > cap) {
    // drain to keep the stream consistent
    std::vector<uint8_t> tmp(static_cast<size_t>(vallen));
    read_full(c->fd, tmp.data(), tmp.size());
    return -3;
  }
  if (!read_full(c->fd, out, static_cast<size_t>(vallen))) return -2;
  return vallen;
}

int64_t pd_store_add(void* handle, const char* key, int64_t delta) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  uint8_t op = 3;
  int64_t keylen = static_cast<int64_t>(strlen(key));
  if (!write_full(c->fd, &op, 1) || !write_i64(c->fd, keylen) ||
      !write_full(c->fd, key, keylen) || !write_i64(c->fd, delta))
    return INT64_MIN;
  uint8_t status;
  int64_t value;
  if (!read_full(c->fd, &status, 1) || !read_i64(c->fd, &value))
    return INT64_MIN;
  return value;
}

int pd_store_check(void* handle, const char* key) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  uint8_t op = 4;
  int64_t keylen = static_cast<int64_t>(strlen(key));
  if (!write_full(c->fd, &op, 1) || !write_i64(c->fd, keylen) ||
      !write_full(c->fd, key, keylen))
    return -1;
  uint8_t status;
  return read_full(c->fd, &status, 1) ? (status == 0 ? 1 : 0) : -1;
}

int pd_store_delete(void* handle, const char* key) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  uint8_t op = 5;
  int64_t keylen = static_cast<int64_t>(strlen(key));
  if (!write_full(c->fd, &op, 1) || !write_i64(c->fd, keylen) ||
      !write_full(c->fd, key, keylen))
    return -1;
  uint8_t status;
  return read_full(c->fd, &status, 1) ? status : -1;
}

// ---- collective watchdog (CommTaskManager analog) ----
// A heartbeat-armed timer: if pd_watchdog_beat is not called within
// timeout_ms, flag trips (reference: comm_task_manager.cc:153 timeout scan).
struct Watchdog {
  std::atomic<int64_t> last_beat_ms{0};
  std::atomic<bool> tripped{false};
  std::atomic<bool> running{true};
  bool abort_on_trip{false};
  int64_t timeout_ms;
  std::thread th;
};

static int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// abort_on_trip: a collective hung past the timeout cannot be unwound from
// Python (the controller thread is blocked inside the runtime), so the
// watchdog thread kills the process — the launcher's restart loop plus
// checkpoint-resume is the recovery path (reference: comm_task_manager.cc
// aborts comms and tears down, nccl_comm_task.cc:233).
void* pd_watchdog_start2(int64_t timeout_ms, int abort_on_trip) {
  auto* w = new Watchdog();
  w->timeout_ms = timeout_ms;
  w->abort_on_trip = abort_on_trip != 0;
  w->last_beat_ms = now_ms();
  w->th = std::thread([w] {
    while (w->running.load()) {
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
      if (now_ms() - w->last_beat_ms.load() > w->timeout_ms) {
        w->tripped = true;
        if (w->abort_on_trip) {
          fprintf(stderr,
                  "[pd_watchdog] no heartbeat within %lld ms - collective "
                  "presumed hung, aborting process\n",
                  (long long)w->timeout_ms);
          fflush(stderr);
          _exit(17);
        }
      }
    }
  });
  return w;
}

void* pd_watchdog_start(int64_t timeout_ms) {
  return pd_watchdog_start2(timeout_ms, 0);
}

void pd_watchdog_beat(void* handle) {
  auto* w = static_cast<Watchdog*>(handle);
  w->last_beat_ms = now_ms();
  w->tripped = false;
}

int pd_watchdog_tripped(void* handle) {
  return static_cast<Watchdog*>(handle)->tripped.load() ? 1 : 0;
}

void pd_watchdog_stop(void* handle) {
  auto* w = static_cast<Watchdog*>(handle);
  w->running = false;
  if (w->th.joinable()) w->th.join();
  delete w;
}

}  // extern "C"

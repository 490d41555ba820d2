// Native async checkpoint IO worker pool (the port's copy of
// paddle_tpu/core/native/ckpt_io.cpp; bound by
// paddle_tpu_torch/distributed/ckpt_io.py).
//
// Reference analog: the sharded-checkpoint save path of
// python/paddle/distributed/checkpoint/save_state_dict.py backed by the
// framework's C++ IO (fluid/framework data IO + the async save threads the
// reference uses for large PS tables). Its role: training steps keep running while the previous snapshot's shards stream
// to disk — a fixed worker pool drains a job queue of (path, buffer) pairs,
// fsyncs, and atomically renames, so a crash never leaves a torn shard.
//
// C ABI (ctypes, no pybind in the image):
//   pd_ckpt_create(n_threads)            -> pool*
//   pd_ckpt_submit(pool, path, buf, n)   -> job id (buffer is COPIED; the
//                                           caller may free immediately)
//   pd_ckpt_pending(pool)                -> jobs not yet durable
//   pd_ckpt_wait(pool, timeout_ms)       -> 0 when drained, 1 on timeout
//   pd_ckpt_errors(pool, buf, cap)       -> newline-joined failed paths
//   pd_ckpt_destroy(pool)                   (drains first)
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Job {
  std::string path;
  std::vector<char> data;
};

struct Pool {
  std::deque<Job> jobs;
  std::mutex mu;
  std::condition_variable cv;       // signals workers: job available/stop
  std::condition_variable done_cv;  // signals waiters: pending changed
  std::vector<std::thread> workers;
  std::atomic<int64_t> submitted{0};
  int64_t completed = 0;  // guarded by mu
  std::string errors;     // guarded by mu
  bool stop = false;

  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !jobs.empty(); });
        if (jobs.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      bool ok = write_one(job);
      {
        std::lock_guard<std::mutex> lk(mu);
        completed++;
        if (!ok) {
          errors += job.path;
          errors += "\n";
        }
      }
      done_cv.notify_all();
    }
  }

  // write to <path>.tmp<pid>, fsync, rename — atomic publication
  static bool write_one(const Job& job) {
    std::string tmp = job.path + ".tmp" + std::to_string(::getpid());
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return false;
    size_t off = 0;
    while (off < job.data.size()) {
      ssize_t n = ::write(fd, job.data.data() + off, job.data.size() - off);
      if (n < 0) {
        ::close(fd);
        ::unlink(tmp.c_str());
        return false;
      }
      off += static_cast<size_t>(n);
    }
    if (::fsync(fd) != 0) {
      ::close(fd);
      ::unlink(tmp.c_str());
      return false;
    }
    ::close(fd);
    if (::rename(tmp.c_str(), job.path.c_str()) != 0) {
      ::unlink(tmp.c_str());
      return false;
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* pd_ckpt_create(uint64_t n_threads) {
  auto* p = new Pool();
  if (n_threads == 0) n_threads = 2;
  for (uint64_t i = 0; i < n_threads; i++) {
    p->workers.emplace_back([p] { p->worker(); });
  }
  return p;
}

int64_t pd_ckpt_submit(void* pool, const char* path, const char* buf,
                       uint64_t nbytes) {
  auto* p = static_cast<Pool*>(pool);
  Job job;
  job.path = path;
  job.data.assign(buf, buf + nbytes);
  int64_t id;
  {
    // submitted must advance under the SAME lock as the queue push, or a
    // concurrent wait() can observe submitted==completed with this job
    // already in a worker's hands and report "drained" early
    std::lock_guard<std::mutex> lk(p->mu);
    p->jobs.push_back(std::move(job));
    id = ++p->submitted;
  }
  p->cv.notify_one();
  return id;
}

int64_t pd_ckpt_pending(void* pool) {
  auto* p = static_cast<Pool*>(pool);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->submitted.load() - p->completed;
}

int pd_ckpt_wait(void* pool, int64_t timeout_ms) {
  auto* p = static_cast<Pool*>(pool);
  std::unique_lock<std::mutex> lk(p->mu);
  auto drained = [&] { return p->submitted.load() == p->completed; };
  if (timeout_ms < 0) {
    p->done_cv.wait(lk, drained);
    return 0;
  }
  bool ok = p->done_cv.wait_for(
      lk, std::chrono::milliseconds(timeout_ms), drained);
  return ok ? 0 : 1;
}

uint64_t pd_ckpt_errors(void* pool, char* buf, uint64_t cap, int clear) {
  auto* p = static_cast<Pool*>(pool);
  std::lock_guard<std::mutex> lk(p->mu);
  uint64_t n = p->errors.size();
  if (buf != nullptr && cap > 0) {
    uint64_t c = n < cap - 1 ? n : cap - 1;
    std::memcpy(buf, p->errors.data(), c);
    buf[c] = '\0';
  }
  if (clear && buf != nullptr) p->errors.clear();  // read-and-clear
  return n;
}

void pd_ckpt_destroy(void* pool) {
  auto* p = static_cast<Pool*>(pool);
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->done_cv.wait(lk, [&] { return p->submitted.load() == p->completed; });
    p->stop = true;
  }
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"

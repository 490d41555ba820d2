// Native bounded blocking queue for DataLoader prefetch.
//
// Reference capability: paddle/fluid/operators/reader/
// lod_tensor_blocking_queue.h (the C++ BlockingQueue under
// use_buffer_reader=True double buffering) and the reader thread of
// io/dataloader/dataloader_iter.py. Samples travel as host byte blobs
// (pickled numpy batches) handed across threads without the GIL; ctypes
// binds this C API (no pybind11). The port's own copy of
// paddle_tpu/core/native/blocking_queue.cpp, built by
// paddle_tpu_torch/core/native_build.py.
//
// Build: g++ -O2 -shared -fPIC -o libpd_bqueue.so blocking_queue.cpp -lpthread
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>

namespace {

struct Blob {
  char* data;
  size_t len;
};

struct BlockingQueue {
  std::deque<Blob> items;
  size_t capacity;
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;

  explicit BlockingQueue(size_t cap) : capacity(cap == 0 ? 1 : cap) {}
};

}  // namespace

extern "C" {

void* pd_bq_create(uint64_t capacity) {
  return new BlockingQueue(static_cast<size_t>(capacity));
}

void pd_bq_destroy(void* h) {
  auto* q = static_cast<BlockingQueue*>(h);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    for (auto& b : q->items) delete[] b.data;
    q->items.clear();
  }
  delete q;
}

// 0 ok, -1 timeout, -2 closed
int pd_bq_push(void* h, const char* buf, uint64_t len, int64_t timeout_ms) {
  auto* q = static_cast<BlockingQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [q] { return q->closed || q->items.size() < q->capacity; };
  if (timeout_ms < 0) {
    q->not_full.wait(lk, pred);
  } else if (!q->not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   pred)) {
    return -1;
  }
  if (q->closed) return -2;
  Blob b;
  b.len = static_cast<size_t>(len);
  b.data = new char[b.len];
  std::memcpy(b.data, buf, b.len);
  q->items.push_back(b);
  q->not_empty.notify_one();
  return 0;
}

// 0 ok (out blob owned by caller; free with pd_bq_free), -1 timeout,
// -2 closed-and-drained
int pd_bq_pop(void* h, char** out, uint64_t* out_len, int64_t timeout_ms) {
  auto* q = static_cast<BlockingQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [q] { return q->closed || !q->items.empty(); };
  if (timeout_ms < 0) {
    q->not_empty.wait(lk, pred);
  } else if (!q->not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    pred)) {
    return -1;
  }
  if (q->items.empty()) return -2;  // closed and drained
  Blob b = q->items.front();
  q->items.pop_front();
  *out = b.data;
  *out_len = b.len;
  q->not_full.notify_one();
  return 0;
}

void pd_bq_free(char* blob) { delete[] blob; }

void pd_bq_close(void* h) {
  auto* q = static_cast<BlockingQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

uint64_t pd_bq_size(void* h) {
  auto* q = static_cast<BlockingQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

uint64_t pd_bq_capacity(void* h) {
  return static_cast<BlockingQueue*>(h)->capacity;
}

}  // extern "C"

// Native runtime for srslte_tpu_torch: the host-side rails around the device
// compute path, mirroring the C library's C++ runtime:
//  - lock-free SPSC ring buffer for IQ samples
//    (lib/src/phy/utils/ringbuffer.c + radio.cc buffering analog)
//  - UDP sample pipe with a background receiver thread feeding the ring
//    (rf_zmq_imp.c / netsource.c virtual-radio transport analog)
//  - TTI clock: a steady-rate ticker with an atomic counter and blocking
//    wait (tti_sync_cv.cc / task_scheduler tick analog)
//
// C ABI for ctypes; samples are interleaved float32 (re, im).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ------------------------------------------------------------ ring buffer
struct RingBuffer {
  std::vector<float> buf;
  size_t capacity;  // in floats
  std::atomic<uint64_t> head{0};  // write position (floats)
  std::atomic<uint64_t> tail{0};  // read position (floats)
};

void* rb_create(uint64_t capacity_floats) {
  auto* rb = new RingBuffer();
  rb->capacity = capacity_floats;
  rb->buf.resize(capacity_floats);
  return rb;
}

void rb_destroy(void* h) { delete static_cast<RingBuffer*>(h); }

uint64_t rb_size(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

// single-producer write; returns floats written (drops on overflow)
uint64_t rb_write(void* h, const float* data, uint64_t n) {
  auto* rb = static_cast<RingBuffer*>(h);
  uint64_t head = rb->head.load(std::memory_order_relaxed);
  uint64_t tail = rb->tail.load(std::memory_order_acquire);
  uint64_t free_space = rb->capacity - (head - tail);
  uint64_t todo = n < free_space ? n : free_space;
  for (uint64_t i = 0; i < todo; ++i)
    rb->buf[(head + i) % rb->capacity] = data[i];
  rb->head.store(head + todo, std::memory_order_release);
  return todo;
}

// single-consumer read; returns floats read
uint64_t rb_read(void* h, float* out, uint64_t n) {
  auto* rb = static_cast<RingBuffer*>(h);
  uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  uint64_t head = rb->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  uint64_t todo = n < avail ? n : avail;
  for (uint64_t i = 0; i < todo; ++i)
    out[i] = rb->buf[(tail + i) % rb->capacity];
  rb->tail.store(tail + todo, std::memory_order_release);
  return todo;
}

// ------------------------------------------------------------ sample pipe
struct PipeTx {
  int fd;
  sockaddr_in addr;
};

void* pipe_tx_create(const char* host, int port) {
  auto* p = new PipeTx();
  p->fd = socket(AF_INET, SOCK_DGRAM, 0);
  std::memset(&p->addr, 0, sizeof(p->addr));
  p->addr.sin_family = AF_INET;
  p->addr.sin_port = htons(port);
  inet_pton(AF_INET, host, &p->addr.sin_addr);
  return p;
}

void pipe_tx_destroy(void* h) {
  auto* p = static_cast<PipeTx*>(h);
  close(p->fd);
  delete p;
}

static const size_t kMaxDgramFloats = 2048;  // 8 KiB datagrams

int64_t pipe_tx_send(void* h, const float* data, uint64_t n) {
  auto* p = static_cast<PipeTx*>(h);
  uint64_t sent = 0;
  while (sent < n) {
    uint64_t chunk = std::min<uint64_t>(kMaxDgramFloats, n - sent);
    ssize_t r = sendto(p->fd, data + sent, chunk * sizeof(float), 0,
                       reinterpret_cast<sockaddr*>(&p->addr), sizeof(p->addr));
    if (r < 0) return -1;
    sent += chunk;
  }
  return static_cast<int64_t>(sent);
}

struct PipeRx {
  int fd;
  RingBuffer* rb;
  std::thread worker;
  std::atomic<bool> running{true};
};

void* pipe_rx_create(int port, uint64_t rb_capacity_floats) {
  auto* p = new PipeRx();
  p->rb = static_cast<RingBuffer*>(rb_create(rb_capacity_floats));
  p->fd = socket(AF_INET, SOCK_DGRAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  bind(p->fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
  timeval tv{0, 100000};  // 100 ms poll so shutdown is prompt
  setsockopt(p->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  // room in the kernel for a whole burst (a 20 MHz subframe at the ZMQ base
  // rate is 184 KB) before the receiver thread drains it; the kernel caps
  // the request at net.core.rmem_max
  int rcvbuf = 8 << 20;
  setsockopt(p->fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  p->worker = std::thread([p]() {
    std::vector<float> tmp(kMaxDgramFloats);
    while (p->running.load(std::memory_order_relaxed)) {
      ssize_t r = recv(p->fd, tmp.data(), tmp.size() * sizeof(float), 0);
      if (r > 0) rb_write(p->rb, tmp.data(), r / sizeof(float));
    }
  });
  return p;
}

uint64_t pipe_rx_read(void* h, float* out, uint64_t n, int timeout_ms) {
  auto* p = static_cast<PipeRx*>(h);
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  uint64_t got = 0;
  while (got < n) {
    got += rb_read(p->rb, out + got, n - got);
    if (got >= n || std::chrono::steady_clock::now() > deadline) break;
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
  return got;
}

void pipe_rx_destroy(void* h) {
  auto* p = static_cast<PipeRx*>(h);
  p->running.store(false);
  p->worker.join();
  close(p->fd);
  rb_destroy(p->rb);
  delete p;
}

// ------------------------------------------------------------ TTI clock
struct TtiClock {
  std::atomic<uint64_t> tti{0};
  std::thread worker;
  std::atomic<bool> running{true};
  std::mutex m;
  std::condition_variable cv;
};

void* ttic_create(uint64_t interval_us) {
  auto* c = new TtiClock();
  c->worker = std::thread([c, interval_us]() {
    auto next = std::chrono::steady_clock::now();
    while (c->running.load(std::memory_order_relaxed)) {
      next += std::chrono::microseconds(interval_us);
      std::this_thread::sleep_until(next);
      c->tti.fetch_add(1, std::memory_order_release);
      c->cv.notify_all();
    }
  });
  return c;
}

uint64_t ttic_now(void* h) {
  return static_cast<TtiClock*>(h)->tti.load(std::memory_order_acquire);
}

// blocks until the counter reaches `tti` (or timeout); returns current tti
uint64_t ttic_wait(void* h, uint64_t tti, int timeout_ms) {
  auto* c = static_cast<TtiClock*>(h);
  std::unique_lock<std::mutex> lk(c->m);
  c->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                 [&]() { return c->tti.load() >= tti; });
  return c->tti.load();
}

void ttic_destroy(void* h) {
  auto* c = static_cast<TtiClock*>(h);
  c->running.store(false);
  c->worker.join();
  delete c;
}

}  // extern "C"

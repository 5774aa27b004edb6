// Native async telemetry runtime: lock-free SPSC ring buffer + writer thread.
//
// The replacement for the reference's logging/video *processes*
// (`PMPC/src/logger.py:10-148` AsyncLogger, `main_parallel_enhanced.py:58-103`
// VideoWriterProcess, SURVEY.md P4/P5): the Python host thread that drives
// device steps pushes fixed-size binary records into a preallocated ring with
// a single atomic store (no GIL-held file I/O, no pickling, no process
// spawn); a C++ writer thread drains the ring to disk. Overflow policy is
// drop-and-count, mirroring the reference's latest-wins/lossy telemetry
// semantics on the control path.
//
// C ABI for ctypes:
//   rl_create(path, record_size, capacity_records) -> handle (0 on error)
//   rl_push(handle, data_ptr)       -> 1 pushed, 0 dropped (ring full)
//   rl_flush(handle)                -> blocks until drained
//   rl_stats(handle, out_uint64[3]) -> {pushed, dropped, written}
//   rl_close(handle)                -> flush, join, close file
//
// Build: tools/build_native.py (g++ -O3 -shared -fPIC -pthread).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct RingLog {
  std::vector<uint8_t> buf;
  size_t record_size = 0;
  size_t capacity = 0;            // in records
  std::atomic<uint64_t> head{0};  // producer index (records)
  std::atomic<uint64_t> tail{0};  // consumer index (records)
  std::atomic<uint64_t> pushed{0};
  std::atomic<uint64_t> dropped{0};
  std::atomic<uint64_t> written{0};
  std::atomic<bool> stop{false};
  std::FILE* file = nullptr;
  std::thread writer;
  std::mutex mu;
  std::condition_variable cv;

  void writer_loop() {
    std::vector<uint8_t> chunk;
    while (true) {
      uint64_t t = tail.load(std::memory_order_relaxed);
      uint64_t h = head.load(std::memory_order_acquire);
      if (t == h) {
        if (stop.load(std::memory_order_acquire)) break;
        std::unique_lock<std::mutex> lk(mu);
        cv.wait_for(lk, std::chrono::milliseconds(5));
        continue;
      }
      // Drain contiguous span (up to ring wrap).
      uint64_t n = h - t;
      uint64_t start = t % capacity;
      uint64_t contig = capacity - start;
      if (n > contig) n = contig;
      std::fwrite(buf.data() + start * record_size, record_size,
                  static_cast<size_t>(n), file);
      written.fetch_add(n, std::memory_order_relaxed);
      tail.store(t + n, std::memory_order_release);
    }
    std::fflush(file);
  }
};

}  // namespace

extern "C" {

void* rl_create(const char* path, uint64_t record_size,
                uint64_t capacity_records) {
  if (record_size == 0 || capacity_records == 0) return nullptr;
  auto* rl = new RingLog();
  rl->record_size = static_cast<size_t>(record_size);
  rl->capacity = static_cast<size_t>(capacity_records);
  rl->buf.resize(rl->record_size * rl->capacity);
  rl->file = std::fopen(path, "wb");
  if (!rl->file) {
    delete rl;
    return nullptr;
  }
  rl->writer = std::thread([rl] { rl->writer_loop(); });
  return rl;
}

int rl_push(void* handle, const void* data) {
  auto* rl = static_cast<RingLog*>(handle);
  uint64_t h = rl->head.load(std::memory_order_relaxed);
  uint64_t t = rl->tail.load(std::memory_order_acquire);
  if (h - t >= rl->capacity) {
    rl->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;  // ring full: drop (lossy telemetry, control path never blocks)
  }
  std::memcpy(rl->buf.data() + (h % rl->capacity) * rl->record_size, data,
              rl->record_size);
  rl->head.store(h + 1, std::memory_order_release);
  rl->pushed.fetch_add(1, std::memory_order_relaxed);
  rl->cv.notify_one();
  return 1;
}

void rl_flush(void* handle) {
  auto* rl = static_cast<RingLog*>(handle);
  while (rl->tail.load(std::memory_order_acquire) !=
         rl->head.load(std::memory_order_acquire)) {
    rl->cv.notify_one();
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  std::fflush(rl->file);
}

void rl_stats(void* handle, uint64_t* out3) {
  auto* rl = static_cast<RingLog*>(handle);
  out3[0] = rl->pushed.load(std::memory_order_relaxed);
  out3[1] = rl->dropped.load(std::memory_order_relaxed);
  out3[2] = rl->written.load(std::memory_order_relaxed);
}

void rl_close(void* handle) {
  auto* rl = static_cast<RingLog*>(handle);
  rl_flush(handle);
  rl->stop.store(true, std::memory_order_release);
  rl->cv.notify_one();
  rl->writer.join();
  std::fclose(rl->file);
  delete rl;
}

}  // extern "C"

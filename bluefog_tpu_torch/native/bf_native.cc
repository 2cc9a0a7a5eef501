// BlueFog-TPU native runtime components.
//
// Chrome-tracing timeline writer: a lock-free single-producer/single-
// consumer ring buffer drained by a dedicated writer thread — the same
// design as the reference's C++ TimelineWriter over a boost::lockfree
// spsc_queue (reference bluefog/common/timeline.h:46-122, timeline.cc),
// rebuilt from scratch with C++11 atomics and no third-party deps.
//
// The producer side must be a single thread (the Python wrapper holds a
// lock); the consumer is the writer thread started at open.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o libbf_native.so bf_native.cc -lpthread

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>

namespace {

constexpr size_t kNameLen = 96;
constexpr size_t kRingSize = 1 << 15;  // events; power of two

struct Event {
  char name[kNameLen];
  char tid[kNameLen];
  char ph;        // 'B' begin, 'E' end, 'i' instant
  double ts_us;   // microseconds since open
};

// SPSC ring buffer: head written by producer, tail by consumer.
class Ring {
 public:
  bool push(const Event& e) {
    const uint64_t h = head_.load(std::memory_order_relaxed);
    const uint64_t t = tail_.load(std::memory_order_acquire);
    if (h - t >= kRingSize) return false;  // full -> caller drops
    buf_[h & (kRingSize - 1)] = e;
    head_.store(h + 1, std::memory_order_release);
    return true;
  }

  bool pop(Event* e) {
    const uint64_t t = tail_.load(std::memory_order_relaxed);
    const uint64_t h = head_.load(std::memory_order_acquire);
    if (t == h) return false;
    *e = buf_[t & (kRingSize - 1)];
    tail_.store(t + 1, std::memory_order_release);
    return true;
  }

 private:
  std::atomic<uint64_t> head_{0};
  std::atomic<uint64_t> tail_{0};
  Event buf_[kRingSize];
};

void JsonEscape(const char* in, char* out, size_t out_len) {
  size_t j = 0;
  for (size_t i = 0; in[i] != '\0' && j + 2 < out_len; ++i) {
    const char c = in[i];
    if (c == '"' || c == '\\') out[j++] = '\\';
    if (static_cast<unsigned char>(c) < 0x20) continue;  // drop control chars
    out[j++] = c;
  }
  out[j] = '\0';
}

class TimelineWriter {
 public:
  TimelineWriter(const char* path, int rank)
      : file_(std::fopen(path, "w")), rank_(rank),
        t0_(std::chrono::steady_clock::now()) {
    if (file_ != nullptr) {
      std::fputs("[\n", file_);
      thread_ = std::thread([this] { Loop(); });
    }
  }

  bool ok() const { return file_ != nullptr; }

  double NowUs() const {
    return std::chrono::duration<double, std::micro>(
               std::chrono::steady_clock::now() - t0_).count();
  }

  void Record(const char* name, const char* tid, char ph) {
    Event e;
    std::snprintf(e.name, kNameLen, "%s", name != nullptr ? name : "");
    std::snprintf(e.tid, kNameLen, "%s", tid != nullptr ? tid : "");
    e.ph = ph;
    e.ts_us = NowUs();
    if (!ring_.push(e)) dropped_.fetch_add(1, std::memory_order_relaxed);
  }

  int64_t Dropped() const {
    return dropped_.load(std::memory_order_relaxed);
  }

  void Close() {
    if (file_ == nullptr) return;
    stop_.store(true, std::memory_order_release);
    if (thread_.joinable()) thread_.join();
    std::fputs("\n]\n", file_);
    std::fclose(file_);
    file_ = nullptr;
  }

  ~TimelineWriter() { Close(); }

 private:
  void Loop() {
    Event e;
    char name_esc[2 * kNameLen];
    char tid_esc[2 * kNameLen];
    while (true) {
      bool got = ring_.pop(&e);
      if (!got) {
        if (stop_.load(std::memory_order_acquire)) {
          if (!ring_.pop(&e)) break;  // fully drained
          got = true;
        } else {
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
          continue;
        }
      }
      JsonEscape(e.name, name_esc, sizeof(name_esc));
      JsonEscape(e.tid, tid_esc, sizeof(tid_esc));
      if (!first_) std::fputs(",\n", file_);
      first_ = false;
      if (e.ph == 'i') {
        std::fprintf(file_,
                     "{\"name\": \"%s\", \"ph\": \"i\", \"ts\": %.3f, "
                     "\"pid\": %d, \"s\": \"p\"}",
                     name_esc, e.ts_us, rank_);
      } else if (e.ph == 'B') {
        std::fprintf(file_,
                     "{\"name\": \"%s\", \"cat\": \"%s\", \"ph\": \"B\", "
                     "\"ts\": %.3f, \"pid\": %d, \"tid\": \"%s\"}",
                     name_esc, tid_esc, e.ts_us, rank_, tid_esc);
      } else {
        std::fprintf(file_,
                     "{\"ph\": \"E\", \"ts\": %.3f, \"pid\": %d, "
                     "\"tid\": \"%s\"}",
                     e.ts_us, rank_, tid_esc);
      }
      if ((++written_ & 0xFF) == 0) std::fflush(file_);
    }
  }

  std::FILE* file_;
  int rank_;
  std::chrono::steady_clock::time_point t0_;
  Ring ring_;
  std::thread thread_;
  std::atomic<bool> stop_{false};
  std::atomic<int64_t> dropped_{0};
  bool first_ = true;
  uint64_t written_ = 0;
};

}  // namespace

extern "C" {

void* bf_timeline_open(const char* path, int rank) {
  auto* w = new TimelineWriter(path, rank);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  return w;
}

void bf_timeline_record(void* handle, const char* name, const char* tid,
                        char ph) {
  if (handle != nullptr)
    static_cast<TimelineWriter*>(handle)->Record(name, tid, ph);
}

long long bf_timeline_dropped(void* handle) {
  return handle != nullptr
             ? static_cast<TimelineWriter*>(handle)->Dropped()
             : -1;
}

void bf_timeline_close(void* handle) {
  if (handle != nullptr) {
    auto* w = static_cast<TimelineWriter*>(handle);
    w->Close();
    delete w;
  }
}

int bf_native_abi_version() { return 1; }

}  // extern "C"

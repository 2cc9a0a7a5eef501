// BlueFog-TPU native data-loading engine.
//
// The reference leans on torch's C++ DataLoader for input (its examples all
// iterate torch DataLoaders); this build supplies its own native input
// pipeline: a multi-threaded batch-gather engine that fills a ring of
// pre-allocated host buffers and hands batches to Python in order.
//
// Division of labor: Python computes WHAT to load (per-epoch index order,
// sharding, shuffling — cheap integer work, and keeping it in one place
// makes the native and pure-Python paths bit-identical); C++ does the HOW
// (the memcpy gather of scattered records into contiguous batch buffers,
// overlapped with compute by worker threads and a depth-deep slot ring).
//
// Concurrency model:
//   * jobs = batch indices, claimed by workers from an atomic counter;
//   * batch b lands in slot b % depth; a worker waits until that slot has
//     been released by the consumer (its previous tenant was b - depth);
//   * the consumer takes batches strictly in order (slot of next_out_),
//     then releases the slot when Python is done with the buffer;
//   * start_epoch quiesces in-flight fills (epoch tag + active counter),
//     resets the ring, installs the new index order.
//
// Build: compiled into libbf_native.so together with bf_native.cc.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> buf;  // all fields, field f at field_offset[f]
  int64_t batch_id = -1;     // which batch is resident (-1: none)
  int64_t count = 0;         // samples in the resident batch
  int64_t turn = 0;          // next batch id this slot may accept
  bool ready = false;        // filled, not yet consumed
  bool free_ = true;         // released by consumer, fillable
};

class DataPipeline {
 public:
  DataPipeline(int n_fields, const uint8_t* const* field_ptrs,
               const int64_t* field_item_bytes, int64_t n_items,
               int64_t batch, int depth, int workers)
      : n_items_(n_items), batch_(batch), depth_(depth) {
    fields_.assign(field_ptrs, field_ptrs + n_fields);
    item_bytes_.assign(field_item_bytes, field_item_bytes + n_fields);
    int64_t off = 0;
    for (int f = 0; f < n_fields; ++f) {
      field_offset_.push_back(off);
      off += batch_ * item_bytes_[f];
    }
    slot_bytes_ = off;
    slots_.resize(depth_);
    for (auto& s : slots_) s.buf.resize(slot_bytes_);
    for (int w = 0; w < workers; ++w)
      threads_.emplace_back([this] { WorkerLoop(); });
  }

  ~DataPipeline() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // Install a new epoch's index order.  Blocks until in-flight fills from
  // the previous epoch have retired; any unconsumed batches are dropped.
  void StartEpoch(const int64_t* order, int64_t n) {
    std::unique_lock<std::mutex> lk(mu_);
    epoch_ += 1;              // in-flight fills see a stale tag and discard
    n_batches_ = 0;           // no new claims
    cv_.wait(lk, [this] { return active_fills_ == 0; });
    order_.assign(order, order + n);
    n_order_ = n;
    for (size_t i = 0; i < slots_.size(); ++i) {
      Slot& s = slots_[i];
      s.batch_id = -1;
      s.count = 0;
      s.turn = static_cast<int64_t>(i);  // slot i serves i, i+depth, ...
      s.ready = false;
      s.free_ = true;
    }
    next_job_ = 0;
    next_out_ = 0;
    n_batches_ = (n + batch_ - 1) / batch_;
    lk.unlock();
    cv_.notify_all();
  }

  int64_t NumBatches() const { return n_batches_; }

  // Returns the slot holding the next batch (blocks), or -1 at epoch end.
  int64_t Next() {
    std::unique_lock<std::mutex> lk(mu_);
    if (next_out_ >= n_batches_) return -1;
    const int64_t want = next_out_;
    Slot& s = slots_[want % depth_];
    cv_.wait(lk, [&] {
      return stop_ || (s.ready && s.batch_id == want);
    });
    if (stop_) return -1;
    next_out_ += 1;
    return want % depth_;
  }

  void Release(int64_t slot) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      Slot& s = slots_[slot];
      s.ready = false;
      s.free_ = true;
      if (s.batch_id >= 0) s.turn = s.batch_id + depth_;
      s.batch_id = -1;
    }
    cv_.notify_all();
  }

  const uint8_t* SlotPtr(int64_t slot, int field) const {
    return slots_[slot].buf.data() + field_offset_[field];
  }

  int64_t SlotCount(int64_t slot) const { return slots_[slot].count; }

 private:
  void WorkerLoop() {
    for (;;) {
      int64_t b, my_epoch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || next_job_ < n_batches_; });
        if (stop_) return;
        b = next_job_++;
        my_epoch = epoch_;
        Slot& s = slots_[b % depth_];
        // wait for the consumer to vacate this slot AND for this batch's
        // turn: with more workers than slots, the worker holding batch
        // b + depth could otherwise seize the slot before batch b, and
        // the in-order consumer would wait forever
        cv_.wait(lk, [&] {
          return stop_ || epoch_ != my_epoch || (s.free_ && s.turn == b);
        });
        if (stop_) return;
        if (epoch_ != my_epoch) continue;  // epoch reset stole the job
        s.free_ = false;
        active_fills_ += 1;
      }
      Fill(b, my_epoch);
    }
  }

  void Fill(int64_t b, int64_t my_epoch) {
    Slot& s = slots_[b % depth_];
    const int64_t start = b * batch_;
    const int64_t count = std::min(batch_, n_order_ - start);
    // the gather itself runs without the lock — this is the heavy part
    for (size_t f = 0; f < fields_.size(); ++f) {
      const int64_t ib = item_bytes_[f];
      uint8_t* dst = s.buf.data() + field_offset_[f];
      const uint8_t* src_base = fields_[f];
      for (int64_t i = 0; i < count; ++i)
        std::memcpy(dst + i * ib, src_base + order_[start + i] * ib, ib);
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      active_fills_ -= 1;
      if (epoch_ == my_epoch) {
        s.batch_id = b;
        s.count = count;
        s.ready = true;
      } else {
        s.free_ = true;  // stale fill: slot back to the pool
      }
    }
    cv_.notify_all();
  }

  std::vector<const uint8_t*> fields_;
  std::vector<int64_t> item_bytes_;
  std::vector<int64_t> field_offset_;
  int64_t n_items_;
  int64_t batch_;
  int64_t depth_;
  int64_t slot_bytes_ = 0;

  std::vector<Slot> slots_;
  std::vector<std::thread> threads_;
  std::vector<int64_t> order_;
  int64_t n_order_ = 0;
  int64_t n_batches_ = 0;
  int64_t next_job_ = 0;
  int64_t next_out_ = 0;
  int64_t epoch_ = 0;
  int64_t active_fills_ = 0;
  bool stop_ = false;
  std::mutex mu_;
  std::condition_variable cv_;
};

}  // namespace

extern "C" {

void* bfdata_create(int n_fields, const uint8_t* const* field_ptrs,
                    const int64_t* field_item_bytes, int64_t n_items,
                    int64_t batch, int depth, int workers) {
  if (n_fields <= 0 || batch <= 0 || depth <= 0 || workers <= 0)
    return nullptr;
  return new DataPipeline(n_fields, field_ptrs, field_item_bytes, n_items,
                          batch, depth, workers);
}

void bfdata_start_epoch(void* h, const int64_t* order, int64_t n) {
  if (h != nullptr)
    static_cast<DataPipeline*>(h)->StartEpoch(order, n);
}

long long bfdata_num_batches(void* h) {
  return h != nullptr ? static_cast<DataPipeline*>(h)->NumBatches() : -1;
}

long long bfdata_next(void* h) {
  return h != nullptr ? static_cast<DataPipeline*>(h)->Next() : -1;
}

void bfdata_release(void* h, long long slot) {
  if (h != nullptr) static_cast<DataPipeline*>(h)->Release(slot);
}

const uint8_t* bfdata_slot_ptr(void* h, long long slot, int field) {
  return h != nullptr
             ? static_cast<DataPipeline*>(h)->SlotPtr(slot, field)
             : nullptr;
}

long long bfdata_slot_count(void* h, long long slot) {
  return h != nullptr ? static_cast<DataPipeline*>(h)->SlotCount(slot) : -1;
}

void bfdata_destroy(void* h) {
  delete static_cast<DataPipeline*>(h);
}

}  // extern "C"

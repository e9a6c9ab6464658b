// Native RecordIO reader with threaded prefetch, part of mxnet_tpu_torch's
// native input library.
//
// Reference: dmlc-core recordio + src/io/iter_prefetcher.h, a C++ threaded
// reader feeding a bounded queue.  A buffered reader parses the on-disk
// format ([uint32 magic][uint32 lrecord][payload][pad4]) on a background
// thread into a bounded record queue, behind a C ABI that
// mxnet_tpu_torch/io_native.py loads with ctypes.
//
// Built at first use by io_native.py with
//   g++ -O2 -std=c++17 -fPIC -pthread -shared recordio.cc image_pipeline.cc

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "recordio_format.h"

namespace {

struct Record {
  std::vector<uint8_t> data;
};

// Bounded MPSC queue — the role of dmlc::ConcurrentBlockingQueue.
class RecordQueue {
 public:
  explicit RecordQueue(size_t cap) : cap_(cap), done_(false) {}

  void Push(Record&& r) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || done_; });
    if (done_) return;
    q_.emplace_back(std::move(r));
    not_empty_.notify_one();
  }

  bool Pop(Record* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || done_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void Finish() {
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  size_t cap_;
  bool done_;
  std::deque<Record> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
};

class RecordIOReader {
 public:
  RecordIOReader(const char* path, size_t queue_cap)
      : path_(path), queue_(queue_cap ? queue_cap : 64) {
    f_ = std::fopen(path, "rb");
    if (f_ != nullptr) {
      worker_ = std::thread([this] { this->Run(); });
    }
  }

  ~RecordIOReader() {
    queue_.Finish();
    if (worker_.joinable()) worker_.join();
    if (f_) std::fclose(f_);
  }

  bool ok() const { return f_ != nullptr; }

  // Returns record size, 0 at EOF, -1 on error.  Copies up to buf_size
  // bytes into buf when buf != nullptr.
  int64_t Next(uint8_t* buf, int64_t buf_size) {
    Record r;
    if (!queue_.Pop(&r)) return 0;
    int64_t n = static_cast<int64_t>(r.data.size());
    if (buf != nullptr) {
      std::memcpy(buf, r.data.data(), std::min(n, buf_size));
    } else {
      // peek mode: stash so the follow-up call with a buffer gets it
      pending_ = std::move(r);
      has_pending_ = true;
    }
    return n;
  }

  int64_t TakePending(uint8_t* buf, int64_t buf_size) {
    if (!has_pending_) return -1;
    int64_t n = static_cast<int64_t>(pending_.data.size());
    std::memcpy(buf, pending_.data.data(), std::min(n, buf_size));
    has_pending_ = false;
    return n;
  }

  // Size of a record already stashed by a peek, or -1 if none.
  int64_t PendingSize() const {
    return has_pending_ ? static_cast<int64_t>(pending_.data.size()) : -1;
  }

 private:
  void Run() {
    while (true) {
      Record r;
      if (!mxtt::ReadRecRecord(f_, &r.data)) break;
      queue_.Push(std::move(r));
    }
    queue_.Finish();
  }

  std::string path_;
  std::FILE* f_;
  RecordQueue queue_;
  std::thread worker_;
  Record pending_;
  bool has_pending_ = false;
};

}  // namespace

extern "C" {

void* MXTTRecordIOReaderCreate(const char* path, int64_t queue_cap) {
  auto* r = new RecordIOReader(path, static_cast<size_t>(queue_cap));
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

void MXTTRecordIOReaderFree(void* handle) {
  delete static_cast<RecordIOReader*>(handle);
}

// Two-phase read: call with buf=nullptr to get the size (record is held),
// then with a buffer to copy it out.  Single-phase works too when the
// caller passes a max-size buffer.
int64_t MXTTRecordIOReaderNext(void* handle, uint8_t* buf,
                                int64_t buf_size) {
  auto* r = static_cast<RecordIOReader*>(handle);
  if (buf == nullptr) return r->Next(nullptr, 0);
  int64_t n = r->TakePending(buf, buf_size);
  if (n >= 0) return n;
  return r->Next(buf, buf_size);
}

// Batch float parse: interpret each record as IRHeader + raw float32
// payload, filling label/data batch arrays host-side in one call
// (the hot path the python loop would otherwise do per record).
int64_t MXTTRecordIOReadFloatBatch(void* handle, float* labels,
                                    float* data, int64_t record_floats,
                                    int64_t batch) {
  auto* r = static_cast<RecordIOReader*>(handle);
  std::vector<uint8_t> buf(24 + record_floats * 4);
  int64_t i = 0;
  while (i < batch) {
    // two-phase: peek the size so flag>0 extra-label records never
    // overflow or truncate regardless of label count; honor a record a
    // caller already stashed via a bare-peek MXTTRecordIOReaderNext
    int64_t n = r->PendingSize();
    if (n < 0) n = r->Next(nullptr, 0);
    if (n <= 0) break;
    if (n > static_cast<int64_t>(buf.size())) buf.resize(n);
    n = r->TakePending(buf.data(), static_cast<int64_t>(buf.size()));
    if (n <= 0) break;
    // IRHeader: uint32 flag, float label, uint64 id, uint64 id2 (24 B).
    // flag > 0 means `flag` label floats follow the header before the
    // data payload (image_recordio.h:68-73 layout).
    if (n < 24) continue;  // truncated / non-IRHeader record: skip
    int64_t avail = std::min<int64_t>(n, static_cast<int64_t>(buf.size()));
    uint32_t flag;
    std::memcpy(&flag, buf.data(), 4);
    int64_t data_off = 24;
    if (flag > 0) {
      data_off = 24 + static_cast<int64_t>(flag) * 4;
      if (data_off > avail) continue;  // header claims more labels than bytes
      std::memcpy(&labels[i], buf.data() + 24, 4);
    } else {
      std::memcpy(&labels[i], buf.data() + 4, 4);
    }
    int64_t nfloats =
        std::min<int64_t>(record_floats,
                          std::max<int64_t>(0, (avail - data_off) / 4));
    if (nfloats > 0) {
      std::memcpy(data + i * record_floats, buf.data() + data_off,
                  nfloats * 4);
    }
    ++i;
  }
  return i;
}

}  // extern "C"

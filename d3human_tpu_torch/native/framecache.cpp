// Native frame-cache loader of the port (a copy of the JAX package's
// d3human_tpu/native/framecache.cpp): an mmap'd decode-once store with an
// async prefetch ring.
//
// A capture's frames are decoded ONCE into a packed binary cache
// (data/frame_cache.py writes it); this library mmaps the cache and runs a
// background prefetch thread that reads ahead the upcoming frames (madvise
// + touch) into the page cache, and copies the current frame into the
// caller's buffer, so the host side of the feed never decodes an image.
//
// C ABI (ctypes-friendly), no external deps beyond pthread.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Header {
  uint64_t magic;        // 0xD3DA7ACAFE
  uint64_t n_frames;
  uint64_t frame_bytes;  // payload bytes per frame
  uint64_t reserved;
};

constexpr uint64_t kMagic = 0xD3DA7ACAFEULL;

class FrameCache {
 public:
  FrameCache(const char* path, int ring) : ring_(ring) {
    fd_ = open(path, O_RDONLY);
    if (fd_ < 0) return;
    struct stat st;
    fstat(fd_, &st);
    size_ = static_cast<size_t>(st.st_size);
    base_ = static_cast<uint8_t*>(
        mmap(nullptr, size_, PROT_READ, MAP_PRIVATE, fd_, 0));
    if (base_ == MAP_FAILED) {
      base_ = nullptr;
      return;
    }
    const Header* h = reinterpret_cast<const Header*>(base_);
    if (h->magic != kMagic) return;
    n_frames_ = h->n_frames;
    frame_bytes_ = h->frame_bytes;
    ok_ = true;
    madvise(base_, size_, MADV_WILLNEED);
    worker_ = std::thread([this] { Prefetcher(); });
  }

  ~FrameCache() {
    stop_.store(true);
    {
      std::lock_guard<std::mutex> g(mu_);
      cv_.notify_all();
    }
    if (worker_.joinable()) worker_.join();
    if (base_) munmap(base_, size_);
    if (fd_ >= 0) close(fd_);
  }

  bool ok() const { return ok_; }
  uint64_t n_frames() const { return n_frames_; }
  uint64_t frame_bytes() const { return frame_bytes_; }

  const uint8_t* FramePtr(uint64_t idx) const {
    return base_ + sizeof(Header) + idx * frame_bytes_;
  }

  // Copy frame into caller buffer; enqueue readahead for the next frames.
  int GetFrame(uint64_t idx, uint8_t* dst) {
    if (!ok_ || idx >= n_frames_) return -1;
    std::memcpy(dst, FramePtr(idx), frame_bytes_);
    {
      std::lock_guard<std::mutex> g(mu_);
      for (int k = 1; k <= ring_; ++k) {
        queue_.push_back((idx + k) % n_frames_);
      }
      if (queue_.size() > static_cast<size_t>(4 * ring_)) {
        queue_.erase(queue_.begin(),
                     queue_.begin() + (queue_.size() - 4 * ring_));
      }
    }
    cv_.notify_one();
    return 0;
  }

  // Explicit hint (e.g. a shuffled schedule known in advance).
  void Hint(const uint64_t* idxs, int n) {
    std::lock_guard<std::mutex> g(mu_);
    for (int i = 0; i < n; ++i) queue_.push_back(idxs[i] % n_frames_);
    cv_.notify_one();
  }

 private:
  void Prefetcher() {
    std::vector<uint64_t> batch;
    volatile uint64_t sink = 0;
    while (!stop_.load()) {
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stop_.load() || !queue_.empty(); });
        if (stop_.load()) return;
        batch.assign(queue_.begin(), queue_.end());
        queue_.clear();
      }
      for (uint64_t idx : batch) {
        const uint8_t* p = FramePtr(idx);
        madvise(const_cast<uint8_t*>(p), frame_bytes_, MADV_WILLNEED);
        // touch one byte per page to force residency
        for (uint64_t off = 0; off < frame_bytes_; off += 4096) {
          sink += p[off];
        }
        if (stop_.load()) return;
      }
    }
    (void)sink;
  }

  int fd_ = -1;
  uint8_t* base_ = nullptr;
  size_t size_ = 0;
  uint64_t n_frames_ = 0;
  uint64_t frame_bytes_ = 0;
  bool ok_ = false;
  int ring_;
  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<uint64_t> queue_;
  std::atomic<bool> stop_{false};
};

}  // namespace

extern "C" {

void* fc_open(const char* path, int ring) {
  auto* fc = new FrameCache(path, ring);
  if (!fc->ok()) {
    delete fc;
    return nullptr;
  }
  return fc;
}

void fc_close(void* h) { delete static_cast<FrameCache*>(h); }

uint64_t fc_n_frames(void* h) {
  return static_cast<FrameCache*>(h)->n_frames();
}

uint64_t fc_frame_bytes(void* h) {
  return static_cast<FrameCache*>(h)->frame_bytes();
}

int fc_get_frame(void* h, uint64_t idx, uint8_t* dst) {
  return static_cast<FrameCache*>(h)->GetFrame(idx, dst);
}

void fc_hint(void* h, const uint64_t* idxs, int n) {
  static_cast<FrameCache*>(h)->Hint(idxs, n);
}

// writer side: append-only builder used by data/frame_cache.py
int fc_write_header(int fd, uint64_t n_frames, uint64_t frame_bytes) {
  Header h{kMagic, n_frames, frame_bytes, 0};
  return write(fd, &h, sizeof(h)) == sizeof(h) ? 0 : -1;
}

}  // extern "C"

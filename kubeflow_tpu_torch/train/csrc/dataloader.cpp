// Native data loader: multi-threaded batch producer with a bounded ring
// buffer, feeding the JAX host-side input pipeline.
//
// The reference's input pipeline is TF's native C++ tier (tf_cnn_benchmarks
// reads via tf.data inside the training image); this is the TPU-native
// equivalent for the framework's own runner/bench: worker threads fill
// pinned int32 token batches from either
//   - a deterministic synthetic stream (splitmix64 per (seed, sample)), or
//   - a memory-mapped binary token file (random crops, epoch-free),
// while the consumer (ctypes, train/native_loader.py) pops complete
// batches without holding the GIL. Throughput goal: keep the host step
// dispatch from ever waiting on data (HBM-bound training must not become
// input-bound).
//
// C ABI only — bound via ctypes (no pybind11 in the image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Config {
  int64_t batch_size;
  int64_t seq_len;
  int64_t vocab_size;
  uint64_t seed;
  int64_t num_threads;
  int64_t queue_depth;
};

// splitmix64: deterministic, splittable — sample i of stream (seed) is a
// pure function, so restarts/replays produce identical data (the same
// contract as data.py's synthetic_text).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

class Loader {
 public:
  Loader(Config cfg, const char* path, bool validate)
      : cfg_(cfg), stop_(false), produced_(0) {
    if (path != nullptr && path[0] != '\0') {
      int fd = ::open(path, O_RDONLY);
      if (fd >= 0) {
        struct stat st;
        if (::fstat(fd, &st) == 0 && st.st_size >= 0) {
          map_size_ = static_cast<size_t>(st.st_size);
          void* m = ::mmap(nullptr, map_size_, PROT_READ, MAP_PRIVATE, fd, 0);
          if (m != MAP_FAILED) {
            tokens_ = static_cast<const int32_t*>(m);
            n_tokens_ = map_size_ / sizeof(int32_t);
          }
        }
        ::close(fd);
      }
      if (tokens_ == nullptr) {
        error_ = 1;  // surfaced via dl_error
        return;
      }
      if (n_tokens_ < static_cast<uint64_t>(cfg_.seq_len + 1)) {
        error_ = 2;
        return;
      }
      if (validate && cfg_.vocab_size > 0) {
        // Whole-corpus range check at open: an out-of-vocab or corrupt
        // token file must fail loudly, not train on clamped garbage
        // (jnp.take clamps out-of-range indices on TPU). The Python
        // binding caches the verdict per (file, size, mtime, vocab) so a
        // multi-GB corpus is paged through once per host, not once per
        // worker per restart.
        for (uint64_t i = 0; i < n_tokens_; ++i) {
          if (tokens_[i] < 0 || tokens_[i] >= cfg_.vocab_size) {
            error_ = 3;
            return;
          }
        }
      }
    }
    const size_t batch_elems =
        static_cast<size_t>(cfg_.batch_size) * cfg_.seq_len;
    slots_.resize(cfg_.queue_depth);
    for (auto& s : slots_) s.data.resize(batch_elems);
    for (int64_t t = 0; t < cfg_.num_threads; ++t)
      workers_.emplace_back([this] { work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_free_.notify_all();
    cv_full_.notify_all();
    for (auto& w : workers_) w.join();
    if (tokens_ != nullptr)
      ::munmap(const_cast<int32_t*>(tokens_), map_size_);
  }

  int error() const { return error_; }

  // Blocking pop of the OLDEST ready batch into out (ordered delivery).
  bool next(int32_t* out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!stop_ && !slot_ready(consume_idx_)) {
      // The training step arrived before the producers: a stall. The
      // bench asserts this stays ~0, proving the pipeline feeds the
      // step rate (BASELINE loader=native row).
      stalls_.fetch_add(1);
    }
    cv_full_.wait(lk, [this] {
      return stop_ || slot_ready(consume_idx_);
    });
    if (stop_) return false;
    Slot& s = slots_[consume_idx_ % slots_.size()];
    std::memcpy(out, s.data.data(), s.data.size() * sizeof(int32_t));
    s.state = kFree;
    ++consume_idx_;
    cv_free_.notify_all();
    return true;
  }

  uint64_t produced() const { return produced_.load(); }

  uint64_t stalls() const { return stalls_.load(); }

 private:
  enum State { kFree = 0, kFilling = 1, kReady = 2 };
  struct Slot {
    std::vector<int32_t> data;
    uint64_t sample_base = 0;
    State state = kFree;
  };

  bool slot_ready(uint64_t idx) {
    return slots_[idx % slots_.size()].state == kReady &&
           slots_[idx % slots_.size()].sample_base ==
               idx * static_cast<uint64_t>(cfg_.batch_size);
  }

  void work() {
    while (true) {
      uint64_t my_batch;
      Slot* slot;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_free_.wait(lk, [this] {
          return stop_ ||
                 slots_[fill_idx_ % slots_.size()].state == kFree;
        });
        if (stop_) return;
        my_batch = fill_idx_++;
        slot = &slots_[my_batch % slots_.size()];
        slot->state = kFilling;
        slot->sample_base =
            my_batch * static_cast<uint64_t>(cfg_.batch_size);
      }
      fill(*slot);
      {
        std::lock_guard<std::mutex> lk(mu_);
        slot->state = kReady;
        produced_.fetch_add(1);
      }
      cv_full_.notify_all();
    }
  }

  void fill(Slot& slot) {
    const int64_t S = cfg_.seq_len;
    for (int64_t b = 0; b < cfg_.batch_size; ++b) {
      const uint64_t sample = slot.sample_base + b;
      int32_t* row = slot.data.data() + b * S;
      if (tokens_ != nullptr) {
        // Random crop, deterministic in (seed, sample).
        const uint64_t span = n_tokens_ - S;
        const uint64_t start = splitmix64(cfg_.seed ^ sample) % span;
        std::memcpy(row, tokens_ + start, S * sizeof(int32_t));
      } else {
        // Synthetic: markov-ish stream with learnable structure (mirrors
        // data.py synthetic_text: next token depends on previous).
        uint64_t state = splitmix64(cfg_.seed ^ (sample * 0x100000001b3ULL));
        int32_t prev = static_cast<int32_t>(state % cfg_.vocab_size);
        for (int64_t i = 0; i < S; ++i) {
          state = splitmix64(state);
          // 75%: deterministic successor (prev*7+3); 25%: random.
          const bool jump = (state & 3) == 0;
          const int32_t succ =
              static_cast<int32_t>((prev * 7 + 3) % cfg_.vocab_size);
          prev = jump ? static_cast<int32_t>((state >> 2) % cfg_.vocab_size)
                      : succ;
          row[i] = prev;
        }
      }
    }
  }

  Config cfg_;
  std::vector<Slot> slots_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_free_, cv_full_;
  bool stop_;
  uint64_t fill_idx_ = 0;
  uint64_t consume_idx_ = 0;
  std::atomic<uint64_t> produced_;
  std::atomic<uint64_t> stalls_{0};
  const int32_t* tokens_ = nullptr;
  uint64_t n_tokens_ = 0;
  size_t map_size_ = 0;
  int error_ = 0;
};

}  // namespace

extern "C" {

void* dl_create(int64_t batch_size, int64_t seq_len, int64_t vocab_size,
                uint64_t seed, int64_t num_threads, int64_t queue_depth,
                const char* token_file, int32_t validate) {
  Config cfg{batch_size, seq_len, vocab_size, seed,
             num_threads > 0 ? num_threads : 2,
             queue_depth > 0 ? queue_depth : 4};
  return new Loader(cfg, token_file, validate != 0);
}

int dl_error(void* h) { return static_cast<Loader*>(h)->error(); }

// Fills out[batch_size * seq_len] int32. Returns 0 on success.
int dl_next(void* h, int32_t* out) {
  return static_cast<Loader*>(h)->next(out) ? 0 : 1;
}

uint64_t dl_produced(void* h) {
  return static_cast<Loader*>(h)->produced();
}

uint64_t dl_stalls(void* h) {
  return static_cast<Loader*>(h)->stalls();
}

void dl_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"

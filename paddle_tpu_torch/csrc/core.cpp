// paddle_tpu_torch native host runtime core: the staging arena, the row
// gather, the shuffling batcher and the MultiSlot text parser.
//
// The port's own copy of paddle_tpu/csrc/core.cpp (arena :33-86,
// ptc_gather_rows :92, the batcher :121-294, ptc_multislot_parse :309),
// built with g++ at first use into paddle_tpu_torch/_build/ by
// paddle_tpu_torch/io/native.py and driven through ctypes (plain C ABI).
// It is host code: no kernel of the card is here.
//
// The batcher's background thread shuffles row indices (Fisher-Yates over
// a splitmix64 stream seeded from seed + epoch) and assembles whole
// batches of every feature array into slot buffers; the consumer pops
// finished slots from a queue and hands each back with
// ptc_batcher_release. The permutation, and so every batch, is the
// reference's bit for bit.
//
// What differs from the reference, and why:
//
// * The slot buffers may be the caller's (slot_buffers, one pointer per
//   slot and array): the Python side passes page-locked buffers when the
//   batches go to a CUDA card, so the copy to the card leaves from the
//   slot itself and the consumer makes no host copy. The batcher never
//   frees buffers it did not allocate. A slot is handed back only once
//   the copy that reads it has completed (io/prefetch.py), so the worker
//   never refills a slot under a copy in flight.
// * An epoch's worker starts at ptc_batcher_start, not when the batcher
//   is built or the last epoch ends, and ptc_batcher_stop ends it, so no
//   thread of the batcher outlives the loop that consumed it.
// * ptc_gather_rows splits by bytes as well as rows: 128 image rows of
//   150,528 bytes are 19 MB, which one thread copies at a fraction of the
//   host's memory rate.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// arena allocator: bump allocator over one big aligned region with reset
// semantics (per-step transient host buffers).

struct Arena {
  char* base;
  size_t capacity;
  std::atomic<size_t> offset;
  std::atomic<size_t> peak;
};

void* ptc_arena_create(size_t bytes) {
  Arena* a = new Arena();
  if (posix_memalign(reinterpret_cast<void**>(&a->base), 4096, bytes) != 0) {
    delete a;
    return nullptr;
  }
  a->capacity = bytes;
  a->offset.store(0);
  a->peak.store(0);
  return a;
}

void ptc_arena_destroy(void* arena) {
  Arena* a = static_cast<Arena*>(arena);
  if (a == nullptr) return;
  free(a->base);
  delete a;
}

void* ptc_arena_alloc(void* arena, size_t bytes, size_t align) {
  Arena* a = static_cast<Arena*>(arena);
  if (align == 0) align = 64;
  size_t cur, aligned, next;
  do {
    cur = a->offset.load(std::memory_order_relaxed);
    aligned = (cur + align - 1) & ~(align - 1);
    next = aligned + bytes;
    if (next > a->capacity) return nullptr;
  } while (!a->offset.compare_exchange_weak(cur, next));
  size_t prev_peak = a->peak.load(std::memory_order_relaxed);
  while (next > prev_peak &&
         !a->peak.compare_exchange_weak(prev_peak, next)) {
  }
  return a->base + aligned;
}

void ptc_arena_reset(void* arena) {
  static_cast<Arena*>(arena)->offset.store(0);
}

size_t ptc_arena_used(void* arena) {
  return static_cast<Arena*>(arena)->offset.load();
}

size_t ptc_arena_peak(void* arena) {
  return static_cast<Arena*>(arena)->peak.load();
}

// ---------------------------------------------------------------------------
// multithreaded row gather: dst[i] = src[idx[i]] for row-major tables.

static const size_t kThreadMinBytes = size_t(1) << 20;

void ptc_gather_rows(const char* src, size_t row_bytes, const int64_t* idx,
                     size_t n_idx, char* dst, int n_threads) {
  if (n_threads <= 1 || n_idx < 2 || (n_idx < 1024 &&
                                      n_idx * row_bytes < kThreadMinBytes)) {
    for (size_t i = 0; i < n_idx; ++i) {
      memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    }
    return;
  }
  std::vector<std::thread> threads;
  size_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    size_t lo = t * chunk;
    size_t hi = lo + chunk < n_idx ? lo + chunk : n_idx;
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      for (size_t i = lo; i < hi; ++i) {
        memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
      }
    });
  }
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// batcher

struct Slot {
  std::vector<char*> buffers;  // one per feature array
  size_t rows;
};

struct Batcher {
  std::vector<const char*> arrays;
  std::vector<size_t> row_bytes;
  size_t n_rows;
  size_t batch;
  bool shuffle;
  bool drop_last;
  bool owns_buffers;
  uint64_t seed;
  uint64_t epoch;

  std::vector<Slot> slots;
  std::queue<int> free_q;
  std::queue<int> ready_q;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::thread worker;
  std::atomic<bool> stop;
  std::atomic<bool> running;
  std::vector<int64_t> perm;

  void halt() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    if (worker.joinable()) worker.join();
  }

  ~Batcher() {
    halt();
    if (owns_buffers)
      for (auto& s : slots)
        for (auto* b : s.buffers) free(b);
  }
};

static uint64_t splitmix64(uint64_t& x) {
  uint64_t z = (x += 0x9E3779B97f4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static void fill_perm(Batcher* b) {
  b->perm.resize(b->n_rows);
  for (size_t i = 0; i < b->n_rows; ++i) b->perm[i] = (int64_t)i;
  if (b->shuffle) {
    uint64_t s = b->seed + 0x9E3779B97f4A7C15ULL * (b->epoch + 1);
    for (size_t i = b->n_rows - 1; i > 0; --i) {
      size_t j = splitmix64(s) % (i + 1);
      std::swap(b->perm[i], b->perm[j]);
    }
  }
}

static void worker_loop(Batcher* b) {
  fill_perm(b);
  size_t n_batches =
      b->drop_last ? b->n_rows / b->batch
                   : (b->n_rows + b->batch - 1) / b->batch;
  for (size_t bi = 0; bi < n_batches && !b->stop.load(); ++bi) {
    int slot_id;
    {
      std::unique_lock<std::mutex> lk(b->mu);
      b->cv_free.wait(lk, [&] { return !b->free_q.empty() || b->stop; });
      if (b->stop.load()) {
        b->running.store(false);
        return;
      }
      slot_id = b->free_q.front();
      b->free_q.pop();
    }
    Slot& s = b->slots[slot_id];
    size_t lo = bi * b->batch;
    size_t hi = lo + b->batch < b->n_rows ? lo + b->batch : b->n_rows;
    s.rows = hi - lo;
    for (size_t ai = 0; ai < b->arrays.size(); ++ai) {
      char* dst = s.buffers[ai];
      const char* src = b->arrays[ai];
      size_t rb = b->row_bytes[ai];
      for (size_t r = 0; r < s.rows; ++r) {
        memcpy(dst + r * rb, src + b->perm[lo + r] * rb, rb);
      }
    }
    {
      std::lock_guard<std::mutex> lk(b->mu);
      b->ready_q.push(slot_id);
    }
    b->cv_ready.notify_one();
  }
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->ready_q.push(-1);  // end-of-epoch sentinel
  }
  b->running.store(false);
  b->cv_ready.notify_one();
}

// slot_buffers: NULL (the batcher allocates and frees its slots) or
// prefetch_slots * n_arrays pointers, slot-major, each to at least
// batch_size * row_bytes[i] bytes that outlive the batcher.
void* ptc_batcher_create(const void** arrays, const size_t* row_bytes,
                         int n_arrays, size_t n_rows, size_t batch_size,
                         int shuffle, int drop_last, uint64_t seed,
                         int prefetch_slots, void* const* slot_buffers) {
  Batcher* b = new Batcher();
  for (int i = 0; i < n_arrays; ++i) {
    b->arrays.push_back(static_cast<const char*>(arrays[i]));
    b->row_bytes.push_back(row_bytes[i]);
  }
  b->n_rows = n_rows;
  b->batch = batch_size;
  b->shuffle = shuffle != 0;
  b->drop_last = drop_last != 0;
  b->owns_buffers = slot_buffers == nullptr;
  b->seed = seed;
  b->epoch = 0;
  b->stop.store(false);
  b->running.store(false);
  if (prefetch_slots < 2) prefetch_slots = 2;
  b->slots.resize(prefetch_slots);
  for (int s = 0; s < prefetch_slots; ++s) {
    for (int i = 0; i < n_arrays; ++i) {
      char* buf;
      if (slot_buffers != nullptr) {
        buf = static_cast<char*>(slot_buffers[s * n_arrays + i]);
      } else if (posix_memalign(reinterpret_cast<void**>(&buf), 4096,
                                batch_size * row_bytes[i]) != 0) {
        delete b;
        return nullptr;
      }
      b->slots[s].buffers.push_back(buf);
    }
    b->free_q.push(s);
  }
  return b;
}

// Starts this epoch's worker; a no-op while one runs or has not been
// collected by ptc_batcher_new_epoch.
void ptc_batcher_start(void* batcher) {
  Batcher* b = static_cast<Batcher*>(batcher);
  if (b->worker.joinable()) return;
  b->stop.store(false);
  b->running.store(true);
  b->worker = std::thread(worker_loop, b);
}

int ptc_batcher_running(void* batcher) {
  return static_cast<Batcher*>(batcher)->running.load() ? 1 : 0;
}

// Returns slot id >= 0 with per-array pointers in out_ptrs and row count
// in out_rows; -1 at the end of the epoch; -2 once the batcher stopped.
int ptc_batcher_next(void* batcher, void** out_ptrs, size_t* out_rows) {
  Batcher* b = static_cast<Batcher*>(batcher);
  int slot_id;
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->cv_ready.wait(lk, [&] { return !b->ready_q.empty() || b->stop; });
    if (b->ready_q.empty()) return -2;
    slot_id = b->ready_q.front();
    b->ready_q.pop();
  }
  if (slot_id < 0) return -1;
  Slot& s = b->slots[slot_id];
  for (size_t i = 0; i < s.buffers.size(); ++i) out_ptrs[i] = s.buffers[i];
  *out_rows = s.rows;
  return slot_id;
}

void ptc_batcher_release(void* batcher, int slot_id) {
  Batcher* b = static_cast<Batcher*>(batcher);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->free_q.push(slot_id);
  }
  b->cv_free.notify_one();
}

// After the end-of-epoch sentinel: collect the worker, advance the epoch
// and put every slot back on the free queue. The next epoch's worker
// starts at ptc_batcher_start.
void ptc_batcher_new_epoch(void* batcher) {
  Batcher* b = static_cast<Batcher*>(batcher);
  if (b->worker.joinable()) b->worker.join();
  b->epoch += 1;
  std::lock_guard<std::mutex> lk(b->mu);
  while (!b->ready_q.empty()) {
    int s = b->ready_q.front();
    b->ready_q.pop();
    if (s >= 0) b->free_q.push(s);
  }
}

// Ends the worker (mid-epoch too) and joins it; the batcher is then only
// fit to be destroyed.
void ptc_batcher_stop(void* batcher) {
  static_cast<Batcher*>(batcher)->halt();
}

void ptc_batcher_destroy(void* batcher) {
  delete static_cast<Batcher*>(batcher);
}


// ---------------------------------------------------------------------------
// MultiSlot text parser (the C++ hot path of the CTR ingest pipeline: a
// single-pass strtod/strtoll token stream).
//
// Format: whitespace-separated tokens; per record, for each of n_slots:
// an integer count then that many values. Line boundaries are plain
// whitespace (the format is self-describing via counts).
//
// out_vals holds 8-byte lanes: double for float slots, int64 bit
// patterns for slots flagged in slot_is_int (exact for the full int64
// range, unlike a float64 round-trip). out_counts is [n_records x
// n_slots]. Returns the record count, or -1 on malformed input.

long long ptc_multislot_parse(const char* text, size_t len, int n_slots,
                              const int* slot_is_int,
                              double* out_vals, long long* out_counts,
                              long long max_vals, long long max_recs,
                              long long* n_vals_out) {
  const char* p = text;
  const char* end = text + len;
  long long rec = 0, vi = 0;
  auto skip_ws = [&]() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                       *p == '\r')) ++p;
  };
  // every token must END at whitespace/EOF: a partial numeric parse
  // ('1.5' read as count 1) would silently misalign the whole stream
  auto at_boundary = [&](const char* q) {
    return q >= end || *q == ' ' || *q == '\t' || *q == '\n' ||
           *q == '\r' || *q == '\0';
  };
  while (true) {
    skip_ws();
    if (p >= end) break;
    if (rec >= max_recs) return -1;
    for (int s = 0; s < n_slots; ++s) {
      skip_ws();
      char* q = nullptr;
      long long cnt = strtoll(p, &q, 10);
      // cnt > max_vals - vi also rejects strtoll's LLONG_MAX overflow
      // clamp without ever computing vi + cnt (signed-overflow UB)
      if (q == p || !at_boundary(q) || cnt < 0 ||
          cnt > max_vals - vi) return -1;
      p = q;
      out_counts[rec * n_slots + s] = cnt;
      for (long long i = 0; i < cnt; ++i) {
        skip_ws();
        if (p >= end) return -1;  // truncated record
        if (slot_is_int[s]) {
          long long v = strtoll(p, &q, 10);
          if (q == p || !at_boundary(q)) return -1;
          memcpy(&out_vals[vi], &v, sizeof v);
        } else {
          double v = strtod(p, &q);
          if (q == p || !at_boundary(q)) return -1;
          out_vals[vi] = v;
        }
        p = q;
        ++vi;
      }
    }
    ++rec;
  }
  *n_vals_out = vi;
  return rec;
}

}  // extern "C"

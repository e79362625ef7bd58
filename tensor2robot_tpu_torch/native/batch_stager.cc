// Native batched record staging: GIL-free file interleave + reservoir
// shuffle + batch assembly.
//
// The host-side staging plane of the data layer. The pure-Python chain
// (`data/pipeline.py` interleave_records -> shuffled -> _batched) pays a
// Python frame per RECORD; this stager runs the whole records->batch
// path on C++ worker threads (one reader thread per active file plus an
// assembler, all outside the GIL) and hands Python ONE contiguous arena
// (+ offsets/lengths) per BATCH, consumed through ctypes by
// `data/stager.py`.
//
// Semantics contract (pinned against the Python chain by the port's
// data tests):
//   * interleave: round-robin passes over up to `cycle_length` active
//     files, refilling from pending between passes — record order is
//     BYTE-IDENTICAL to `interleave_records` for a given file list
//     (file-order shuffling stays in Python so train-mode file order is
//     also identical);
//   * shuffle: tf.data-style reservoir buffer. Same algorithm as
//     `shuffled`, driven by std::mt19937_64 instead of Python's
//     MT19937 wrapper — same distribution, deterministic per seed, not
//     the identical permutation; buffer_size 0 is a pass-through, so
//     eval mode stays byte-identical end to end;
//   * batching: `_batched` semantics incl. drop_remainder;
//   * errors: corrupt/truncated records surface through
//     t2r_stager_error (Python raises IOError, matching both
//     iter_records paths).
//
// One stager handles ONE epoch (one pass over the given file list);
// Python owns repeat + per-epoch seeds, keeping epoch semantics in one
// place.
//
// The port's own copy of the JAX package's stager, unchanged in
// behaviour: one seed stages the same batches in both packages.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "record_framing.h"

namespace {

constexpr auto kWaitSlice = std::chrono::milliseconds(50);

// One assembled batch: contiguous payload arena + per-record offsets
// and lengths. Heap-owned and handed to Python (t2r_staged_free) so the
// consumer, parse workers, and the stager never share a live buffer.
struct StagedBatch {
  std::vector<uint8_t> arena;
  std::vector<int64_t> offsets;
  std::vector<int64_t> lengths;
};

// Sequential TFRecord framing reader over one file.
struct RecordReader {
  FILE* file = nullptr;
  bool verify_crc = false;
  std::string error;

  bool open(const std::string& path, bool verify) {
    file = std::fopen(path.c_str(), "rb");
    verify_crc = verify;
    if (!file) error = "Cannot open " + path;
    return file != nullptr;
  }

  ~RecordReader() {
    if (file) std::fclose(file);
  }

  // 1 = record read, 0 = clean EOF, -1 = corruption (error set).
  // Framing (header parse, CRC checks, length cap) is the shared
  // record_framing.h contract — identical error classes to the batched
  // Reader in tfrecord_io.cc by construction.
  int next(std::string* out) {
    uint64_t length;
    int status = t2r::ReadRecordHeader(file, verify_crc, &length, &error);
    if (status <= 0) return status;
    out->resize(length);
    if (length &&
        std::fread(&(*out)[0], 1, length, file) < length) {
      error = "truncated body";
      return -1;
    }
    return t2r::ReadRecordFooter(
        file, verify_crc, reinterpret_cast<const uint8_t*>(out->data()),
        length, &error);
  }
};

// Bounded SPSC record queue between one reader thread and the
// assembler. All waits are stop-aware wait_for loops so close() never
// needs to reach into per-file condition variables; `closed` retires
// ONE reader (assembler-side teardown) without touching the global
// stop flag — resetting a shared flag there would race a concurrent
// close().
struct RecordQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::string> items;
  size_t cap;
  size_t byte_cap;        // 0 = unbounded; always admits into an empty
                          // queue so one over-cap record still flows
  size_t bytes = 0;       // payload bytes currently buffered
  bool done = false;      // reader finished (EOF or error)
  int status = 0;         // 0 clean EOF, -1 error
  std::string error;
  std::atomic<bool> closed{false};

  RecordQueue(size_t capacity, size_t byte_capacity)
      : cap(capacity), byte_cap(byte_capacity) {}

  bool full() const {
    if (items.empty()) return false;
    return items.size() >= cap || (byte_cap && bytes >= byte_cap);
  }

  void push(std::string&& rec, const std::atomic<bool>& stop) {
    std::unique_lock<std::mutex> lock(mu);
    while (full() && !stop.load() && !closed.load())
      cv.wait_for(lock, kWaitSlice);
    if (stop.load() || closed.load()) return;
    bytes += rec.size();
    items.push_back(std::move(rec));
    cv.notify_all();
  }

  void finish(int s, std::string err) {
    std::lock_guard<std::mutex> lock(mu);
    done = true;
    status = s;
    error = std::move(err);
    cv.notify_all();
  }

  // 1 = record popped, 0 = clean EOF, -1 = error, -2 = stopping.
  int pop(std::string* out, const std::atomic<bool>& stop) {
    std::unique_lock<std::mutex> lock(mu);
    while (items.empty() && !done && !stop.load())
      cv.wait_for(lock, kWaitSlice);
    if (!items.empty()) {
      *out = std::move(items.front());
      items.pop_front();
      bytes -= out->size();
      cv.notify_all();
      return 1;
    }
    if (stop.load()) return -2;
    return status == 0 ? 0 : -1;
  }
};

struct ActiveFile {
  std::unique_ptr<RecordQueue> queue;
  std::thread thread;
  bool retired = false;  // reader finished AND joined; safe to destroy
};

struct Stager {
  // configuration
  std::vector<std::string> paths;
  int64_t cycle_length = 4;
  int64_t shuffle_buffer = 0;
  uint64_t seed = 0;
  int64_t batch_size = 1;
  bool drop_remainder = true;
  bool verify_crc = false;
  size_t queue_depth = 2;
  size_t reader_depth = 64;  // records buffered per reader thread
  // Reader queues are ALWAYS byte-bounded (admission blocks past the
  // cap unless the queue is empty, so one over-cap record still flows):
  // a count-only bound would pin reader_depth x cycle_length multi-MB
  // records — GiBs of host RSS on episode-record feeds — where the
  // Python chain buffered ~one record per file. Exact-batch assembly is
  // untouched by this cap; the batches themselves are whatever the
  // caller asked for.
  static constexpr size_t kReaderByteCap = 16ull << 20;  // 16 MiB/file
  // 0 = exact-batch mode. When set, a batch ALSO flushes EARLY once its
  // arena reaches this size, and the reader byte cap tightens to match
  // — record-mode consumers (iter_staged_records) use it to bound the
  // whole plane to ~O(cycle_length + queue_depth) chunks regardless of
  // record size. Batch-mode pipelines MUST pass 0: early flush would
  // break exact batch_size semantics.
  int64_t max_chunk_bytes = 0;

  // output queue (assembler -> consumer)
  std::mutex mu;
  std::condition_variable cv;
  std::deque<StagedBatch*> out;
  bool finished = false;
  std::string error;
  std::atomic<bool> stop{false};
  std::thread assembler;

  ~Stager() {
    stop.store(true);
    if (assembler.joinable()) assembler.join();
    for (StagedBatch* b : out) delete b;
  }

  void fail(const std::string& message) {
    std::lock_guard<std::mutex> lock(mu);
    if (error.empty()) error = message;
    finished = true;
    cv.notify_all();
  }

  // Blocks until the consumer drains a slot; false when stopping.
  bool emit_batch(StagedBatch* batch) {
    std::unique_lock<std::mutex> lock(mu);
    while (out.size() >= queue_depth && !stop.load())
      cv.wait_for(lock, kWaitSlice);
    if (stop.load()) {
      delete batch;
      return false;
    }
    out.push_back(batch);
    cv.notify_all();
    return true;
  }

  // Worker body. The reader threads in `active` MUST be joined via
  // stop_readers on EVERY exit path — including an exception unwind
  // (e.g. bad_alloc staging a near-cap record): destroying a joinable
  // std::thread calls std::terminate, so the try block wraps the loop
  // while `active` and the join live outside it.
  void run() {
    std::mt19937_64 rng(seed);
    std::vector<std::string> shuffle_buf;
    std::vector<ActiveFile> active;
    StagedBatch* batch = nullptr;
    bool ok = true;
    std::string failure;
    try {
      run_guarded(rng, shuffle_buf, active, batch, ok, failure);
    } catch (const std::exception& e) {
      ok = false;
      if (failure.empty()) failure = e.what();
    }
    stop_readers(active);
    delete batch;
    if (!failure.empty()) {
      fail(failure);
    } else {
      std::lock_guard<std::mutex> lock(mu);
      finished = true;
      cv.notify_all();
    }
  }

  void run_guarded(std::mt19937_64& rng,
                   std::vector<std::string>& shuffle_buf,
                   std::vector<ActiveFile>& active, StagedBatch*& batch,
                   bool& ok, std::string& failure) {
    if (shuffle_buffer > 0)
      shuffle_buf.reserve(static_cast<size_t>(shuffle_buffer));
    batch = new StagedBatch();

    auto flush = [&]() -> bool {
      StagedBatch* full = batch;
      batch = new StagedBatch();
      return emit_batch(full);
    };
    auto append = [&](std::string&& rec) -> bool {
      batch->offsets.push_back(static_cast<int64_t>(batch->arena.size()));
      batch->lengths.push_back(static_cast<int64_t>(rec.size()));
      batch->arena.insert(batch->arena.end(), rec.begin(), rec.end());
      if (static_cast<int64_t>(batch->offsets.size()) == batch_size ||
          (max_chunk_bytes > 0 &&
           static_cast<int64_t>(batch->arena.size()) >= max_chunk_bytes))
        return flush();
      return true;
    };
    // Reservoir shuffle, `data/pipeline.shuffled` semantics: fill the
    // buffer, then evict a random slot per arriving record.
    auto route = [&](std::string&& rec) -> bool {
      if (shuffle_buffer <= 0) return append(std::move(rec));
      if (static_cast<int64_t>(shuffle_buf.size()) < shuffle_buffer) {
        shuffle_buf.push_back(std::move(rec));
        return true;
      }
      size_t idx = std::uniform_int_distribution<size_t>(
          0, static_cast<size_t>(shuffle_buffer) - 1)(rng);
      std::string evicted = std::move(shuffle_buf[idx]);
      shuffle_buf[idx] = std::move(rec);
      return append(std::move(evicted));
    };

    auto activate = [&](std::vector<ActiveFile>& active, size_t i) {
      ActiveFile file;
      file.queue.reset(new RecordQueue(
          reader_depth,
          max_chunk_bytes > 0 ? static_cast<size_t>(max_chunk_bytes)
                              : kReaderByteCap));
      RecordQueue* queue = file.queue.get();
      std::string path = paths[i];
      bool verify = verify_crc;
      std::atomic<bool>* stopping = &stop;
      // The try/catch mirrors run()'s and t2r_reader_next_batch's
      // guards: a bad_alloc on a near-cap record (garbage length field
      // under kMaxRecordBytes, unverified CRC) must surface as a
      // stream error, not std::terminate out of the thread body.
      file.thread = std::thread([queue, path, verify, stopping]() {
        try {
          RecordReader reader;
          if (!reader.open(path, verify)) {
            queue->finish(-1, reader.error);
            return;
          }
          std::string rec;
          while (!stopping->load() && !queue->closed.load()) {
            int status = reader.next(&rec);
            if (status == 1) {
              queue->push(std::move(rec), *stopping);
              continue;
            }
            queue->finish(status,
                          status == 0 ? "" : path + ": " + reader.error);
            return;
          }
          queue->finish(0, "");
        } catch (const std::exception& e) {
          queue->finish(-1, path + ": " + e.what());
        }
      });
      active.push_back(std::move(file));
    };

    // interleave_records parity: refill before each round-robin pass,
    // appending new files at the END of the active list; a file that
    // exhausts contributes nothing to its final pass. Every live reader
    // stays inside `active` (owned by run(), handed to stop_readers on
    // ANY unwind) for the whole pass — a second vector holding moved-out
    // joinable threads would std::terminate if route() threw mid-pass.
    // `reserve` keeps the activate() push_back from ever reallocating
    // (cycle_length bounds the size), so no throw point holds a
    // joinable thread outside `active`.
    active.reserve(static_cast<size_t>(
        std::min<int64_t>(cycle_length,
                          static_cast<int64_t>(paths.size()))));
    size_t pending = 0;
    while (ok && (pending < paths.size() || !active.empty()) &&
           !stop.load()) {
      while (pending < paths.size() &&
             static_cast<int64_t>(active.size()) < cycle_length)
        activate(active, pending++);
      for (ActiveFile& file : active) {
        if (!ok) break;  // remaining readers stay for stop_readers
        std::string rec;
        int status = file.queue->pop(&rec, stop);
        if (status == 1) {
          ok = route(std::move(rec));
        } else {
          // The reader already finished (EOF/error) — join is immediate.
          file.thread.join();
          file.retired = true;
          if (status == -1) {
            ok = false;
            failure = file.queue->error;
          } else if (status == -2) {
            ok = false;  // stopping; no error message
          }
        }
      }
      // remove_if keeps relative order: surviving files hold their
      // round-robin slots, matching the old next_active rebuild.
      active.erase(std::remove_if(active.begin(), active.end(),
                                  [](const ActiveFile& f) {
                                    return f.retired;
                                  }),
                   active.end());
    }
    if (!ok || stop.load()) return;  // run() joins readers + finishes
    // End of stream: Fisher-Yates the residual shuffle buffer (Python
    // rng.shuffle parity in distribution), then the final partial batch.
    if (!shuffle_buf.empty()) {
      for (size_t i = shuffle_buf.size() - 1; i > 0; --i) {
        size_t j = std::uniform_int_distribution<size_t>(0, i)(rng);
        std::swap(shuffle_buf[i], shuffle_buf[j]);
      }
      for (std::string& rec : shuffle_buf)
        if (!append(std::move(rec))) return;  // stopping mid-drain
    }
    if (!batch->offsets.empty() && !drop_remainder) {
      emit_batch(batch);  // takes ownership (deletes itself on stop)
      batch = nullptr;
    }
  }

  void stop_readers(std::vector<ActiveFile>& active) {
    // Retire leftover readers via their per-queue `closed` flags (never
    // the shared stop flag — see RecordQueue). Draining each queue
    // unblocks a reader mid-push immediately instead of after a wait
    // slice.
    for (ActiveFile& file : active) {
      file.queue->closed.store(true);
      std::lock_guard<std::mutex> lock(file.queue->mu);
      file.queue->items.clear();
      file.queue->cv.notify_all();
    }
    for (ActiveFile& file : active)
      if (file.thread.joinable()) file.thread.join();
    active.clear();
  }

  StagedBatch* next_batch() {
    std::unique_lock<std::mutex> lock(mu);
    while (out.empty() && !finished && !stop.load())
      cv.wait_for(lock, kWaitSlice);
    if (!out.empty()) {
      StagedBatch* batch = out.front();
      out.pop_front();
      cv.notify_all();
      return batch;
    }
    return nullptr;
  }
};

}  // namespace

extern "C" {

// Opens a stager over `paths` (FINAL order — file shuffling is the
// caller's job) for one epoch. Staging begins immediately on background
// threads. queue_depth bounds staged-batch read-ahead; max_chunk_bytes
// (0 = off) byte-bounds reader queues and flushes batches early — see
// Stager::max_chunk_bytes for when that is legal.
void* t2r_stager_open(const char** paths, int64_t n_files,
                      int64_t cycle_length, int64_t shuffle_buffer,
                      uint64_t seed, int64_t batch_size,
                      int drop_remainder, int verify_crc,
                      int64_t queue_depth, int64_t max_chunk_bytes) {
  if (n_files <= 0 || batch_size <= 0) return nullptr;
  Stager* stager = new Stager();
  for (int64_t i = 0; i < n_files; ++i) stager->paths.emplace_back(paths[i]);
  stager->cycle_length = cycle_length > 0 ? cycle_length : 1;
  stager->shuffle_buffer = shuffle_buffer;
  stager->seed = seed;
  stager->batch_size = batch_size;
  stager->drop_remainder = drop_remainder != 0;
  stager->verify_crc = verify_crc != 0;
  stager->queue_depth =
      queue_depth > 0 ? static_cast<size_t>(queue_depth) : 1;
  stager->max_chunk_bytes = max_chunk_bytes > 0 ? max_chunk_bytes : 0;
  stager->assembler = std::thread([stager]() { stager->run(); });
  return stager;
}

// Blocks until a batch is staged. NULL at end of stream OR on error —
// the caller must check t2r_stager_error to tell them apart. The
// returned batch is owned by the caller (t2r_staged_free).
void* t2r_stager_next_batch(void* handle) {
  return static_cast<Stager*>(handle)->next_batch();
}

// Non-empty iff the stream died on corruption/IO failure.
const char* t2r_stager_error(void* handle) {
  Stager* stager = static_cast<Stager*>(handle);
  std::lock_guard<std::mutex> lock(stager->mu);
  return stager->error.c_str();
}

// Staged batches currently waiting for the consumer (queue-depth gauge:
// 0 in steady state means Python consumes faster than the plane stages).
int64_t t2r_stager_queue_depth(void* handle) {
  Stager* stager = static_cast<Stager*>(handle);
  std::lock_guard<std::mutex> lock(stager->mu);
  return static_cast<int64_t>(stager->out.size());
}

void t2r_stager_close(void* handle) {
  delete static_cast<Stager*>(handle);  // ~Stager stops + joins threads
}

int64_t t2r_staged_count(void* batch) {
  return static_cast<int64_t>(
      static_cast<StagedBatch*>(batch)->offsets.size());
}

const uint8_t* t2r_staged_data(void* batch) {
  return static_cast<StagedBatch*>(batch)->arena.data();
}

const int64_t* t2r_staged_offsets(void* batch) {
  return static_cast<StagedBatch*>(batch)->offsets.data();
}

const int64_t* t2r_staged_lengths(void* batch) {
  return static_cast<StagedBatch*>(batch)->lengths.data();
}

int64_t t2r_staged_arena_bytes(void* batch) {
  return static_cast<int64_t>(static_cast<StagedBatch*>(batch)->arena.size());
}

void t2r_staged_free(void* batch) {
  delete static_cast<StagedBatch*>(batch);
}

}  // extern "C"

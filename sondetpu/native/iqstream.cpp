// Native streaming IQ reader: background prefetch + format conversion.
//
// Accelerator-native equivalent of the reference's dsp::stream / dsp::block runtime
// (SURVEY.md C1/C2: double-buffered SPSC handoff with a worker thread per
// block). Here one reader thread fills a ring of pre-converted float I/Q
// plane buffers while the Python driver keeps the device busy — host file
// IO and sample conversion overlap device compute instead of serializing
// with it. Works on regular files and FIFOs/pipes (fread blocks until data
// or EOF), so a live SDR front-end can feed the decoder through a pipe.
//
// Loaded via ctypes from sondetpu/io/iq.py (StreamingIQSource).

#include <poll.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum Fmt { kCF32 = 0, kCS16 = 1, kCS8 = 2, kCU8 = 3 };

size_t bytes_per_complex(int fmt) {
  switch (fmt) {
    case kCF32: return 8;
    case kCS16: return 4;
    case kCS8: return 2;
    case kCU8: return 2;
  }
  return 0;
}

struct Slot {
  std::vector<float> plane_i, plane_q;   // float mode
  std::vector<uint8_t> int_i, int_q;     // raw mode (int8/int16 planes)
  int64_t n_valid = 0;
  bool ready = false;
};

struct Stream {
  FILE *f = nullptr;
  int fmt = kCF32;
  int64_t block = 0;
  float scale = 1.0f;
  bool raw_mode = false;   // deinterleave to integer planes, no float
  size_t elem = 0;         // bytes per raw plane element (raw mode)
  std::vector<Slot> slots;
  std::vector<uint8_t> raw;
  size_t head = 0, tail = 0;  // head: next slot to fill, tail: next to read
  bool eof = false;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread reader;

  void convert(const uint8_t *src, Slot &s, int64_t n) {
    if (raw_mode) {
      // device-dequant ingest: split interleaved ints into raw planes
      // (the device casts+scales); no float math on the host at all
      if (elem == 2) {
        const int16_t *p = reinterpret_cast<const int16_t *>(src);
        int16_t *di = reinterpret_cast<int16_t *>(s.int_i.data());
        int16_t *dq = reinterpret_cast<int16_t *>(s.int_q.data());
        for (int64_t k = 0; k < n; ++k) {
          di[k] = p[2 * k];
          dq[k] = p[2 * k + 1];
        }
      } else {
        int8_t *di = reinterpret_cast<int8_t *>(s.int_i.data());
        int8_t *dq = reinterpret_cast<int8_t *>(s.int_q.data());
        const int8_t *p = reinterpret_cast<const int8_t *>(src);
        for (int64_t k = 0; k < n; ++k) {
          di[k] = p[2 * k];
          dq[k] = p[2 * k + 1];
        }
      }
      if (n < block) {
        std::memset(s.int_i.data() + n * elem, 0, (block - n) * elem);
        std::memset(s.int_q.data() + n * elem, 0, (block - n) * elem);
      }
      return;
    }
    float *di = s.plane_i.data(), *dq = s.plane_q.data();
    switch (fmt) {
      case kCF32: {
        const float *p = reinterpret_cast<const float *>(src);
        for (int64_t k = 0; k < n; ++k) {
          di[k] = p[2 * k] * scale;
          dq[k] = p[2 * k + 1] * scale;
        }
        break;
      }
      case kCS16: {
        const int16_t *p = reinterpret_cast<const int16_t *>(src);
        for (int64_t k = 0; k < n; ++k) {
          di[k] = static_cast<float>(p[2 * k]) * scale;
          dq[k] = static_cast<float>(p[2 * k + 1]) * scale;
        }
        break;
      }
      case kCS8: {
        const int8_t *p = reinterpret_cast<const int8_t *>(src);
        for (int64_t k = 0; k < n; ++k) {
          di[k] = static_cast<float>(p[2 * k]) * scale;
          dq[k] = static_cast<float>(p[2 * k + 1]) * scale;
        }
        break;
      }
      case kCU8: {
        for (int64_t k = 0; k < n; ++k) {
          di[k] = (static_cast<float>(src[2 * k]) - 127.5f) * scale;
          dq[k] = (static_cast<float>(src[2 * k + 1]) - 127.5f) * scale;
        }
        break;
      }
    }
    if (n < block) {
      std::memset(di + n, 0, (block - n) * sizeof(float));
      std::memset(dq + n, 0, (block - n) * sizeof(float));
    }
  }

  // Interruptible bulk read: poll with a 200 ms timeout between ::read
  // calls so iqs_close's stop flag ends a reader blocked on a stalled
  // FIFO (a plain fread would block forever and iqs_close's join with it
  // — which is how Ctrl-C used to hang the whole decode process).
  size_t read_full(uint8_t *dst, size_t want) {
    const int fd = fileno(f);
    size_t got = 0;
    while (got < want && !stop.load(std::memory_order_relaxed)) {
      struct pollfd pfd = {fd, POLLIN, 0};
      const int pr = poll(&pfd, 1, 200);
      if (pr < 0) {
        if (errno == EINTR) continue;
        break;
      }
      if (pr == 0) continue;                       // timeout: re-check stop
      const ssize_t r = ::read(fd, dst + got, want - got);
      if (r < 0) {
        if (errno == EINTR || errno == EAGAIN) continue;
        break;
      }
      if (r == 0) break;                           // true EOF
      got += static_cast<size_t>(r);
    }
    return got;
  }

  void run() {
    const size_t bpc = bytes_per_complex(fmt);
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return stop.load() || !slots[head].ready; });
      if (stop.load()) return;
      Slot &s = slots[head];
      lk.unlock();

      const size_t want = static_cast<size_t>(block) * bpc;
      size_t got = read_full(raw.data(), want);
      if (stop.load(std::memory_order_relaxed)) return;
      const int64_t n = static_cast<int64_t>(got / bpc);
      if (n > 0) convert(raw.data(), s, n);
      s.n_valid = n;

      lk.lock();
      s.ready = true;
      head = (head + 1) % slots.size();
      const bool at_eof = (got < want);
      if (at_eof) eof = true;
      cv_data.notify_one();
      if (at_eof) return;
    }
  }
};

}  // namespace

extern "C" {

// depth = ring slots (>=2). Returns NULL on open failure.
void *iqs_open(const char *path, int fmt, int64_t block_complex, float scale,
               int depth) {
  if (fmt < 0 || fmt > 3 || block_complex <= 0 || depth < 2) return nullptr;
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  Stream *s = new Stream;
  s->f = f;
  s->fmt = fmt;
  s->block = block_complex;
  s->scale = scale;
  s->slots.resize(depth);
  for (auto &sl : s->slots) {
    sl.plane_i.resize(block_complex);
    sl.plane_q.resize(block_complex);
  }
  s->raw.resize(static_cast<size_t>(block_complex) * bytes_per_complex(fmt));
  s->reader = std::thread([s] { s->run(); });
  return s;
}

// Raw-plane variant for cs16/cs8 (device-dequant ingest): blocks come out
// as int16/int8 planes, never touching float on the host.
void *iqs_open_raw(const char *path, int fmt, int64_t block_complex,
                   int depth) {
  if ((fmt != kCS16 && fmt != kCS8) || block_complex <= 0 || depth < 2)
    return nullptr;
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  Stream *s = new Stream;
  s->f = f;
  s->fmt = fmt;
  s->block = block_complex;
  s->raw_mode = true;
  s->elem = (fmt == kCS16) ? 2 : 1;
  s->slots.resize(depth);
  for (auto &sl : s->slots) {
    sl.int_i.resize(static_cast<size_t>(block_complex) * s->elem);
    sl.int_q.resize(static_cast<size_t>(block_complex) * s->elem);
  }
  s->raw.resize(static_cast<size_t>(block_complex) * bytes_per_complex(fmt));
  s->reader = std::thread([s] { s->run(); });
  return s;
}

// Raw-plane read: dst buffers hold block_complex int16/int8 elements.
int64_t iqs_read_raw(void *h, void *dst_i, void *dst_q) {
  Stream *s = static_cast<Stream *>(h);
  if (!s->raw_mode) return -1;  // opened with iqs_open: no integer planes
  std::unique_lock<std::mutex> lk(s->mu);
  // bounded wait: a stalled FIFO must return control to Python so SIGINT
  // (Ctrl-C -> checkpoint/finalize) can fire between calls; -2 = try again
  if (!s->cv_data.wait_for(lk, std::chrono::milliseconds(200),
                           [&] { return s->slots[s->tail].ready || s->eof; }))
    return -2;
  Slot &sl = s->slots[s->tail];
  if (!sl.ready) return 0;
  const int64_t n = sl.n_valid;
  if (n > 0) {
    std::memcpy(dst_i, sl.int_i.data(), s->block * s->elem);
    std::memcpy(dst_q, sl.int_q.data(), s->block * s->elem);
  }
  sl.ready = false;
  s->tail = (s->tail + 1) % s->slots.size();
  s->cv_space.notify_one();
  return n;
}

// Copies the next block's I/Q planes (block_complex floats each, zero-padded
// past n_valid). Returns n_valid; 0 means end of stream.
int64_t iqs_read(void *h, float *dst_i, float *dst_q) {
  Stream *s = static_cast<Stream *>(h);
  if (s->raw_mode) return -1;  // opened with iqs_open_raw: no float planes
  std::unique_lock<std::mutex> lk(s->mu);
  if (!s->cv_data.wait_for(lk, std::chrono::milliseconds(200),
                           [&] { return s->slots[s->tail].ready || s->eof; }))
    return -2;  // timeout: let the caller service signals and retry
  Slot &sl = s->slots[s->tail];
  if (!sl.ready) return 0;  // eof and ring drained
  const int64_t n = sl.n_valid;
  if (n > 0) {
    std::memcpy(dst_i, sl.plane_i.data(), s->block * sizeof(float));
    std::memcpy(dst_q, sl.plane_q.data(), s->block * sizeof(float));
  }
  sl.ready = false;
  s->tail = (s->tail + 1) % s->slots.size();
  s->cv_space.notify_one();
  return n;
}

void iqs_close(void *h) {
  Stream *s = static_cast<Stream *>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop = true;
    s->cv_space.notify_all();
  }
  if (s->reader.joinable()) s->reader.join();
  fclose(s->f);
  delete s;
}

}  // extern "C"

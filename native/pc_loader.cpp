// Native runtime components for vofod_tpu.
//
// Fast ASCII point-cloud parsing (the reference's pc_loader is C++,
// src/pc_loader.cpp; this is its standalone equivalent for this
// framework's host runtime) plus a lock-free SPSC scan ring buffer used by
// the streaming data loader (the nodelet's subscriber queue analogue,
// ref mrs_lib::SubscribeHandler usage at vofod_nodelet.cpp:1102-1122).
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read whole file into a buffer.
static char* read_file(const char* path, long long* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(sz + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  if (std::fread(buf, 1, sz, f) != static_cast<size_t>(sz)) {
    std::free(buf);
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  buf[sz] = '\0';
  *size_out = sz;
  return buf;
}

static bool has_suffix(const char* s, const char* suf) {
  size_t ls = std::strlen(s), lf = std::strlen(suf);
  return ls >= lf && std::strcmp(s + ls - lf, suf) == 0;
}

//

struct Cursor {
  const char* p;
  const char* end;
};

static inline void skip_ws_inline(Cursor& c) {
  while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) ++c.p;
}

static inline void skip_line(Cursor& c) {
  while (c.p < c.end && *c.p != '\n') ++c.p;
  if (c.p < c.end) ++c.p;
}

// parse up to three floats on the current line; returns count parsed
static inline int parse_point_line(Cursor& c, float out[3]) {
  int n = 0;
  while (n < 3) {
    skip_ws_inline(c);
    if (c.p >= c.end || *c.p == '\n') break;
    char* endp = nullptr;
    float v = std::strtof(c.p, &endp);
    if (endp == c.p) break;
    out[n++] = v;
    c.p = endp;
  }
  skip_line(c);
  return n;
}

}  // namespace

extern "C" {

// Count points in an ASCII .pts/.txt cloud (ref pc_loader.cpp:31-49:
// .pts first line holds the count; otherwise count non-empty lines).
// Returns -1 on error.
long long vofod_count_points(const char* path) {
  long long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;
  Cursor c{buf, buf + size};
  long long count = 0;
  bool pts = has_suffix(path, ".pts");
  if (pts) {
    skip_ws_inline(c);
    char* endp = nullptr;
    long long declared = std::strtoll(c.p, &endp, 10);
    if (endp != c.p) {
      // a single token on the first line => declared count
      Cursor t{endp, c.end};
      skip_ws_inline(t);
      if (t.p >= t.end || *t.p == '\n') {
        std::free(buf);
        return declared;
      }
    }
  }
  while (c.p < c.end) {
    skip_ws_inline(c);
    if (c.p < c.end && *c.p != '\n') ++count;
    skip_line(c);
  }
  std::free(buf);
  return count;
}

// Parse points into out[3*capacity]; returns number written, -1 on error.
long long vofod_load_cloud(const char* path, float* out, long long capacity) {
  long long size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return -1;
  Cursor c{buf, buf + size};
  if (has_suffix(path, ".pts")) {
    // skip the count line if it is a single integer token
    Cursor probe = c;
    skip_ws_inline(probe);
    char* endp = nullptr;
    (void)std::strtoll(probe.p, &endp, 10);
    if (endp != probe.p) {
      Cursor t{endp, c.end};
      skip_ws_inline(t);
      if (t.p >= t.end || *t.p == '\n') skip_line(c);
    }
  }
  long long n = 0;
  while (c.p < c.end && n < capacity) {
    float xyz[3];
    skip_ws_inline(c);
    if (c.p >= c.end) break;
    if (*c.p == '\n') {
      skip_line(c);
      continue;
    }
    int got = parse_point_line(c, xyz);
    if (got == 3) {
      out[3 * n + 0] = xyz[0];
      out[3 * n + 1] = xyz[1];
      out[3 * n + 2] = xyz[2];
      ++n;
    } else if (got > 0) {
      std::free(buf);
      return -1;  // malformed line (ref errors out, pc_loader.cpp:52-60)
    }
  }
  std::free(buf);
  return n;
}

// ---------------------------------------------------------------------------
// SPSC scan ring buffer: fixed-capacity queue of fixed-size scan frames.
// Producer (sensor/reader thread) and consumer (pipeline feeder) lock-free.
// ---------------------------------------------------------------------------

struct VofodScanQueue {
  long long frame_bytes;
  long long capacity;
  std::vector<uint8_t> data;
  std::atomic<long long> head{0};  // next write
  std::atomic<long long> tail{0};  // next read
  std::atomic<long long> dropped{0};
};

void* vofod_queue_create(long long frame_bytes, long long capacity) {
  auto* q = new VofodScanQueue();
  q->frame_bytes = frame_bytes;
  q->capacity = capacity;
  q->data.resize(frame_bytes * capacity);
  return q;
}

void vofod_queue_destroy(void* vq) { delete static_cast<VofodScanQueue*>(vq); }

// returns 1 on success, 0 when full (frame dropped, counted — the
// reference's subscriber queue drops old scans the same way)
int vofod_queue_push(void* vq, const uint8_t* frame) {
  auto* q = static_cast<VofodScanQueue*>(vq);
  long long head = q->head.load(std::memory_order_relaxed);
  long long tail = q->tail.load(std::memory_order_acquire);
  if (head - tail >= q->capacity) {
    q->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  std::memcpy(&q->data[(head % q->capacity) * q->frame_bytes], frame,
              q->frame_bytes);
  q->head.store(head + 1, std::memory_order_release);
  return 1;
}

// returns 1 on success, 0 when empty
int vofod_queue_pop(void* vq, uint8_t* frame_out) {
  auto* q = static_cast<VofodScanQueue*>(vq);
  long long tail = q->tail.load(std::memory_order_relaxed);
  long long head = q->head.load(std::memory_order_acquire);
  if (tail >= head) return 0;
  std::memcpy(frame_out, &q->data[(tail % q->capacity) * q->frame_bytes],
              q->frame_bytes);
  q->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

long long vofod_queue_size(void* vq) {
  auto* q = static_cast<VofodScanQueue*>(vq);
  return q->head.load(std::memory_order_acquire) -
         q->tail.load(std::memory_order_acquire);
}

long long vofod_queue_dropped(void* vq) {
  return static_cast<VofodScanQueue*>(vq)->dropped.load(
      std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// Destagger: shift row u of an organized (H, W) u32 field by shift[u]
// (the reference relies on ouster_ros for this; needed for raw packets).
// ---------------------------------------------------------------------------
void vofod_destagger_u32(const uint32_t* in, uint32_t* out, long long H,
                         long long W, const int* shift) {
  for (long long u = 0; u < H; ++u) {
    const uint32_t* row = in + u * W;
    uint32_t* orow = out + u * W;
    long long s = ((shift[u] % W) + W) % W;
    for (long long v = 0; v < W; ++v) {
      orow[v] = row[(v + s) % W];
    }
  }
}

}  // extern "C"

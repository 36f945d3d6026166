// Shared-memory SPSC ring — the btl/sm data plane.
//
// Reference: opal/mca/btl/sm per-peer FIFOs (btl_sm_sendi.c, fastboxes
// btl_sm_fbox.h) and the lock-free fifo of opal/class/opal_fifo.c.
// Redesign: one single-producer/single-consumer byte ring per (sender,
// receiver) pair living in the receiver's mmap segment. Cursors are
// monotonic uint64s (never wrapped), so "used = head - tail" needs no
// full/empty disambiguation; frames are 8-byte aligned and contiguous,
// with a WRAP sentinel when a frame won't fit before the physical end.
//
// C ABI, no dependencies: built with `g++ -O2 -shared -fPIC` by
// ompi_tpu_torch/native/__init__.py and driven through ctypes (no
// pybind11; ctypes keeps the binding dependency-free). The layout is the
// one of the JAX package's ring, byte for byte, so a ring of either
// package can share a segment with a ring of the other.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct alignas(64) RingHdr {
    std::atomic<uint64_t> head;  // producer cursor (monotonic byte count)
    char pad1[56];               // keep producer/consumer lines apart
    std::atomic<uint64_t> tail;  // consumer cursor (monotonic)
    char pad2[56];
    uint64_t capacity;           // data-area bytes (multiple of 8)
    uint64_t magic;
    char pad3[48];
};

static_assert(sizeof(RingHdr) == 192, "ring header layout");

constexpr uint64_t MAGIC = 0x534d52494e470002ull;
constexpr uint64_t WRAP = ~0ull;  // frame-length sentinel: skip to start

inline uint8_t* data_area(uint8_t* base) { return base + sizeof(RingHdr); }
inline uint64_t align8(uint64_t v) { return (v + 7) & ~7ull; }

}  // namespace

extern "C" {

// Total per-ring overhead callers must budget for.
uint64_t smr_header_bytes() { return sizeof(RingHdr); }

int smr_init(uint8_t* base, uint64_t total_bytes) {
    if (total_bytes < sizeof(RingHdr) + 1024) return -1;
    RingHdr* h = new (base) RingHdr;
    h->head.store(0, std::memory_order_relaxed);
    h->tail.store(0, std::memory_order_relaxed);
    h->capacity = (total_bytes - sizeof(RingHdr)) & ~7ull;
    h->magic = MAGIC;
    std::atomic_thread_fence(std::memory_order_release);
    return 0;
}

uint64_t smr_capacity(uint8_t* base) {
    return reinterpret_cast<RingHdr*>(base)->capacity;
}

// Push one frame made of two segments (header + payload, gathered here so
// Python never concatenates). Returns 1 = pushed, 0 = ring full (retry
// later), -1 = frame can never fit / corrupt ring.
int smr_push2(uint8_t* base, const uint8_t* hdr, uint64_t hlen,
              const uint8_t* payload, uint64_t plen) {
    RingHdr* h = reinterpret_cast<RingHdr*>(base);
    if (h->magic != MAGIC) return -1;
    const uint64_t cap = h->capacity;
    const uint64_t len = hlen + plen;
    const uint64_t need = align8(8 + len);
    if (need + 8 > cap) return -1;

    const uint64_t head = h->head.load(std::memory_order_relaxed);
    const uint64_t tail = h->tail.load(std::memory_order_acquire);
    const uint64_t pos = head % cap;
    const uint64_t to_end = cap - pos;
    uint64_t skip = 0;
    if (to_end < need) skip = to_end;  // frame must start at physical 0
    if ((head + skip + need) - tail > cap) return 0;  // would overwrite

    uint8_t* d = data_area(base);
    uint64_t wpos = pos;
    if (skip) {
        std::memcpy(d + pos, &WRAP, 8);
        wpos = 0;
    }
    std::memcpy(d + wpos, &len, 8);
    if (hlen) std::memcpy(d + wpos + 8, hdr, hlen);
    if (plen) std::memcpy(d + wpos + 8 + hlen, payload, plen);
    h->head.store(head + skip + need, std::memory_order_release);
    return 1;
}

// Pop one frame into `out`. Returns frame length (>0), 0 = empty,
// -1 = out buffer too small or corrupt ring.
int64_t smr_pop(uint8_t* base, uint8_t* out, uint64_t outcap) {
    RingHdr* h = reinterpret_cast<RingHdr*>(base);
    if (h->magic != MAGIC) return -1;
    const uint64_t cap = h->capacity;
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    const uint64_t head = h->head.load(std::memory_order_acquire);
    if (head == tail) return 0;

    uint8_t* d = data_area(base);
    uint64_t pos = tail % cap;
    uint64_t len;
    std::memcpy(&len, d + pos, 8);
    if (len == WRAP) {
        tail += cap - pos;
        pos = 0;
        if (head == tail) {  // producer wrapped but hasn't written yet
            h->tail.store(tail, std::memory_order_release);
            return 0;
        }
        std::memcpy(&len, d, 8);
    }
    if (len > outcap || len > cap) return -1;
    std::memcpy(out, d + pos + 8, len);
    h->tail.store(tail + align8(8 + len), std::memory_order_release);
    return static_cast<int64_t>(len);
}

// Zero-copy consume: expose the next frame's (offset, length) within the
// data area without copying; the caller reads the bytes in place and then
// calls smr_advance. Consumes WRAP sentinels internally. Returns frame
// length (>0), 0 = empty, -1 = corrupt.
int64_t smr_peek(uint8_t* base, uint64_t* pos_out) {
    RingHdr* h = reinterpret_cast<RingHdr*>(base);
    if (h->magic != MAGIC) return -1;
    const uint64_t cap = h->capacity;
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    const uint64_t head = h->head.load(std::memory_order_acquire);
    if (head == tail) return 0;
    uint8_t* d = data_area(base);
    uint64_t pos = tail % cap;
    uint64_t len;
    std::memcpy(&len, d + pos, 8);
    if (len == WRAP) {
        tail += cap - pos;
        pos = 0;
        h->tail.store(tail, std::memory_order_release);
        if (head == tail) return 0;
        std::memcpy(&len, d, 8);
    }
    if (len > cap) return -1;
    *pos_out = pos;
    return static_cast<int64_t>(len);
}

// Release the frame returned by the last smr_peek.
void smr_advance(uint8_t* base, uint64_t frame_len) {
    RingHdr* h = reinterpret_cast<RingHdr*>(base);
    const uint64_t tail = h->tail.load(std::memory_order_relaxed);
    h->tail.store(tail + align8(8 + frame_len), std::memory_order_release);
}

// Bytes currently enqueued (diagnostic / tests).
uint64_t smr_used(uint8_t* base) {
    RingHdr* h = reinterpret_cast<RingHdr*>(base);
    return h->head.load(std::memory_order_acquire) -
           h->tail.load(std::memory_order_acquire);
}

}  // extern "C"

// framepipe.cpp — native frame-transport runtime for the TPU feeder.
//
// The TPU-native counterpart of the reference's C/C++ L2 transport:
// GAsyncQueue + preallocated GstBuffers + the binary-only ProcessedFrame
// resequencer (reference OpenCVequalHist.cpp:71-98, improvement ELF).
// Python-level per-frame work (slicing, memcpy, dict bookkeeping) costs
// real milliseconds at 4K60; these pieces run in C++ with the GIL released
// (ctypes releases it around foreign calls).
//
// Components:
//   fp_ring   — fixed-capacity leaky ring of preallocated frame slots
//               (drop-oldest under overload, like queue leaky=downstream).
//               Producers memcpy into a slot; the feeder assembles a batch
//               into one contiguous staging buffer for device_put.
//   fp_reseq  — out-of-order sequence reorderer with late-drop (the
//               std::map<uint64_t, ProcessedFrame*> of the improvement ELF).
//   nv12 ops  — interleave/deinterleave UV, gray-fill, plane splits.
//
// Build: g++ -O3 -march=native -shared -fPIC framepipe.cpp -o libframepipe.so
// (done automatically by opencv_opencl_tpu.native.build)

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ring ----

struct FpRingEntry {
    uint64_t seq;
    size_t slot;
    int32_t prio;  // QoS class; overflow evicts the oldest lowest-prio
};

struct FpRing {
    size_t frame_bytes;
    size_t capacity;
    std::vector<uint8_t> storage;          // capacity * frame_bytes
    std::deque<FpRingEntry> queue;
    std::deque<size_t> free_slots;
    std::mutex mu;
    std::condition_variable cv;
    std::atomic<uint64_t> dropped{0};
    std::atomic<uint64_t> pushed{0};
    bool closed = false;
};

FpRing* fp_ring_new(size_t capacity, size_t frame_bytes) {
    auto* r = new FpRing();
    r->frame_bytes = frame_bytes;
    r->capacity = capacity;
    r->storage.resize(capacity * frame_bytes);
    for (size_t i = 0; i < capacity; ++i) r->free_slots.push_back(i);
    return r;
}

void fp_ring_free(FpRing* r) { delete r; }

// Priority-aware push (the QoS serving hook: StreamMux premium streams
// keep the GIL-free staging path).  On overflow the OLDEST entry among
// those with the LOWEST priority is evicted — the PriorityLeakyQueue
// policy, GIL-free; equal priorities degrade to plain drop-oldest.  The
// evicted frame's seq is written to *evicted_seq_out so per-stream drop
// accounting stays attributable (the round-2 FIFO ring could not say
// WHOSE frame it evicted).
// Returns: 0 = queued, no drop; 1 = queued, old frame evicted (seq in
// *evicted_seq_out); 2 = incoming frame itself rejected (ranks below
// everything queued — not copied); -1 = closed.
int fp_ring_push_prio(FpRing* r, const uint8_t* data, uint64_t seq,
                      int32_t prio, uint64_t* evicted_seq_out) {
    size_t slot;
    int rc = 0;
    {
        std::lock_guard<std::mutex> lk(r->mu);
        if (r->closed) return -1;
        if (r->free_slots.empty()) {
            if (r->queue.empty()) {
                // every slot is in flight between producers' memcpy and
                // re-queue (or inside pop_batch): nothing to evict.
                // Reject the incoming frame — reading queue.front() here
                // would be UB on an empty deque.
                r->dropped.fetch_add(1, std::memory_order_relaxed);
                return 2;
            }
            // oldest entry of the lowest priority class (bounded scan:
            // capacity is small by design, like PriorityLeakyQueue)
            size_t idx = 0;
            int32_t pmin = r->queue.front().prio;
            for (size_t i = 1; i < r->queue.size(); ++i) {
                if (r->queue[i].prio < pmin) {
                    pmin = r->queue[i].prio;
                    idx = i;
                }
            }
            r->dropped.fetch_add(1, std::memory_order_relaxed);
            if (pmin <= prio) {
                if (evicted_seq_out) *evicted_seq_out = r->queue[idx].seq;
                slot = r->queue[idx].slot;
                r->queue.erase(r->queue.begin() + idx);
                rc = 1;
            } else {
                return 2;  // incoming ranks below the whole queue
            }
        } else {
            slot = r->free_slots.front();
            r->free_slots.pop_front();
        }
    }
    std::memcpy(&r->storage[slot * r->frame_bytes], data, r->frame_bytes);
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->queue.push_back({seq, slot, prio});
        r->pushed.fetch_add(1, std::memory_order_relaxed);
    }
    r->cv.notify_one();
    return rc;
}

// Push one frame (memcpy into a slot). Returns 0 when queued with no
// drop, 1 when A frame was dropped (usually the oldest queued one; on a
// ring mixed with higher-priority push_prio frames, or in the transient
// where every slot is in flight, the dropped frame is the INCOMING one),
// -1 if closed.
int fp_ring_push(FpRing* r, const uint8_t* data, uint64_t seq) {
    int rc = fp_ring_push_prio(r, data, seq, 0, nullptr);
    return rc == 2 ? 1 : rc;
}

// Pop up to max_frames frames into the contiguous batch buffer (batch
// assembly for device_put). Blocks up to timeout_ms for the first frame.
// Writes their seqs into seqs_out. Returns the number of frames copied
// (0 on timeout, -1 if closed and drained).
int64_t fp_ring_pop_batch(FpRing* r, uint8_t* batch_out, uint64_t* seqs_out,
                          size_t max_frames, int64_t timeout_ms) {
    std::vector<size_t> slots;
    {
        std::unique_lock<std::mutex> lk(r->mu);
        if (r->queue.empty()) {
            if (r->closed) return -1;
            r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                           [&] { return !r->queue.empty() || r->closed; });
            if (r->queue.empty()) return r->closed ? -1 : 0;
        }
        size_t n = std::min(max_frames, r->queue.size());
        slots.reserve(n);
        for (size_t i = 0; i < n; ++i) {
            FpRingEntry e = r->queue.front();
            r->queue.pop_front();
            seqs_out[i] = e.seq;
            slots.push_back(e.slot);
        }
    }
    for (size_t i = 0; i < slots.size(); ++i) {
        std::memcpy(batch_out + i * r->frame_bytes,
                    &r->storage[slots[i] * r->frame_bytes], r->frame_bytes);
    }
    {
        std::lock_guard<std::mutex> lk(r->mu);
        for (size_t s : slots) r->free_slots.push_back(s);
    }
    return static_cast<int64_t>(slots.size());
}

int64_t fp_ring_len(FpRing* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return static_cast<int64_t>(r->queue.size());
}

uint64_t fp_ring_dropped(FpRing* r) { return r->dropped.load(); }

void fp_ring_close(FpRing* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
    r->cv.notify_all();
}

// ---------------------------------------------------------- resequencer ----

struct FpReseq {
    std::map<uint64_t, std::vector<uint8_t>> pending;
    uint64_t next_seq = 0;
    size_t max_pending;
    size_t frame_bytes;
    std::atomic<uint64_t> dropped_late{0};
    std::atomic<uint64_t> frames_lost{0};
    std::mutex mu;
};

FpReseq* fp_reseq_new(size_t max_pending, size_t frame_bytes) {
    auto* q = new FpReseq();
    q->max_pending = max_pending;
    q->frame_bytes = frame_bytes;
    return q;
}

void fp_reseq_free(FpReseq* q) { delete q; }

// Push frame with sequence number. Returns number of frames now ready to
// emit in order (fetch with fp_reseq_emit). Late frames are counted+dropped.
int64_t fp_reseq_push(FpReseq* q, uint64_t seq, const uint8_t* data) {
    std::lock_guard<std::mutex> lk(q->mu);
    if (seq < q->next_seq) {
        q->dropped_late.fetch_add(1, std::memory_order_relaxed);
        return 0;
    }
    q->pending.emplace(seq, std::vector<uint8_t>(data, data + q->frame_bytes));
    if (q->pending.size() > q->max_pending) {
        uint64_t oldest = q->pending.begin()->first;
        if (oldest > q->next_seq) {
            q->frames_lost.fetch_add(oldest - q->next_seq,
                                     std::memory_order_relaxed);
            q->next_seq = oldest;
        }
    }
    int64_t ready = 0;
    uint64_t s = q->next_seq;
    for (auto it = q->pending.find(s); it != q->pending.end();
         it = q->pending.find(++s))
        ++ready;
    return ready;
}

// Emit the next in-order frame into out. Returns its seq, or -1 if the next
// frame is not ready.
int64_t fp_reseq_emit(FpReseq* q, uint8_t* out) {
    std::lock_guard<std::mutex> lk(q->mu);
    auto it = q->pending.find(q->next_seq);
    if (it == q->pending.end()) return -1;
    std::memcpy(out, it->second.data(), q->frame_bytes);
    int64_t seq = static_cast<int64_t>(it->first);
    q->pending.erase(it);
    q->next_seq = seq + 1;
    return seq;
}

uint64_t fp_reseq_dropped_late(FpReseq* q) { return q->dropped_late.load(); }
uint64_t fp_reseq_frames_lost(FpReseq* q) { return q->frames_lost.load(); }

int64_t fp_reseq_pending(FpReseq* q) {
    std::lock_guard<std::mutex> lk(q->mu);
    return static_cast<int64_t>(q->pending.size());
}

// ------------------------------------------------------------- nv12 ops ----

// Interleave separate U and V quarter-planes into NV12 UV rows.
void fp_uv_interleave(const uint8_t* u, const uint8_t* v, uint8_t* uv,
                      size_t half_h, size_t half_w) {
    for (size_t r = 0; r < half_h; ++r) {
        const uint8_t* ur = u + r * half_w;
        const uint8_t* vr = v + r * half_w;
        uint8_t* o = uv + r * 2 * half_w;
        for (size_t c = 0; c < half_w; ++c) {
            o[2 * c] = ur[c];
            o[2 * c + 1] = vr[c];
        }
    }
}

void fp_uv_deinterleave(const uint8_t* uv, uint8_t* u, uint8_t* v,
                        size_t half_h, size_t half_w) {
    for (size_t r = 0; r < half_h; ++r) {
        const uint8_t* in = uv + r * 2 * half_w;
        uint8_t* ur = u + r * half_w;
        uint8_t* vr = v + r * half_w;
        for (size_t c = 0; c < half_w; ++c) {
            ur[c] = in[2 * c];
            vr[c] = in[2 * c + 1];
        }
    }
}

// The reference's gray chroma policy: memset(uv, 128, size)
// (OpenCVequalHist.cpp:162).
void fp_uv_gray(uint8_t* uv, size_t bytes) { std::memset(uv, 128, bytes); }

}  // extern "C"

// ---------------------------------------------------------------- rtp ----
// Raw NV12 line packetizer + sender (io/rtp.py RawNv12Payloader wire
// format: 12 B RTP header, 2 B extended seq (0), one 6 B SRD
// (length, line, offset), payload). Python-side per-packet loops cost
// ~10k syscalls+pack calls per 4K frame; here headers are built in an
// arena, payloads ride zero-copy iovecs into sendmmsg batches, GIL-free.
// The reference analogue is udpsink's socket loop (OpenCVequalHist.cpp:316).

#include <sys/socket.h>
#include <sys/uio.h>
#include <netinet/in.h>
#include <arpa/inet.h>

namespace {
inline void put16(uint8_t* p, uint16_t v) {
    p[0] = uint8_t(v >> 8);
    p[1] = uint8_t(v);
}
inline void put32(uint8_t* p, uint32_t v) {
    p[0] = uint8_t(v >> 24);
    p[1] = uint8_t(v >> 16);
    p[2] = uint8_t(v >> 8);
    p[3] = uint8_t(v);
}
}  // namespace

// Generic pre-built-packet batch sender: `data` holds n packets
// back-to-back with lengths in `lens`; sendmmsg in batches of 64,
// GIL-free via ctypes.  Serves every native RTP sink (JPEG/H.26x/raw
// fallback) — the Python per-packet sendto loop costs ~33 ms for a
// 10k-packet 4K PCM access unit; this is one join + a few syscalls.
// Failure encoding matches fp_rtp_send_raw: -(sent+1).
extern "C" int64_t fp_send_packets(int fd, const uint8_t* data,
                                   const uint64_t* lens, uint64_t n,
                                   const char* host, uint16_t port) {
    sockaddr_in dest{};
    dest.sin_family = AF_INET;
    dest.sin_port = htons(port);
    if (inet_pton(AF_INET, host, &dest.sin_addr) != 1) return -1;
    constexpr size_t kBatch = 64;
    mmsghdr msgs[kBatch];
    iovec iovs[kBatch];
    const uint8_t* p = data;
    int64_t sent = 0;
    uint64_t i = 0;
    while (i < n) {
        size_t m = 0;
        for (; m < kBatch && i < n; ++m, ++i) {
            iovs[m] = {const_cast<uint8_t*>(p), size_t(lens[i])};
            msghdr& h = msgs[m].msg_hdr;
            h = msghdr{};
            h.msg_name = &dest;
            h.msg_namelen = sizeof(dest);
            h.msg_iov = &iovs[m];
            h.msg_iovlen = 1;
            msgs[m].msg_len = 0;
            p += lens[i];
        }
        size_t done = 0;
        while (done < m) {
            int r = sendmmsg(fd, msgs + done, unsigned(m - done), 0);
            if (r <= 0) return -(sent + int64_t(done)) - 1;
            done += size_t(r);
        }
        sent += int64_t(m);
    }
    return sent;
}

extern "C" int64_t fp_rtp_send_raw(int fd, const uint8_t* frame,
                                   uint64_t rows, uint64_t width,
                                   uint64_t mtu, uint32_t seq0, uint32_t ts,
                                   uint32_t ssrc, uint8_t pt,
                                   const char* host, uint16_t port) {
    if (mtu <= 20 || rows == 0 || width == 0) return -1;  // = -(0+1): 0 sent
    sockaddr_in dest{};
    dest.sin_family = AF_INET;
    dest.sin_port = htons(port);
    if (inet_pton(AF_INET, host, &dest.sin_addr) != 1) return -1;
    const uint64_t room = mtu - 12 - 2 - 6;
    constexpr size_t kBatch = 64;
    constexpr size_t kHdr = 20;
    uint8_t arena[kBatch * kHdr];
    mmsghdr msgs[kBatch];
    iovec iovs[kBatch][2];
    uint16_t seq = uint16_t(seq0);
    int64_t sent = 0;
    size_t n_in_batch = 0;
    auto flush = [&]() -> bool {
        size_t done = 0;
        while (done < n_in_batch) {
            int r = sendmmsg(fd, msgs + done, unsigned(n_in_batch - done), 0);
            if (r <= 0) {
                sent += int64_t(done);
                return false;
            }
            done += size_t(r);
        }
        sent += int64_t(n_in_batch);
        n_in_batch = 0;
        return true;
    };
    for (uint64_t line = 0; line < rows; ++line) {
        for (uint64_t off = 0; off < width;) {
            uint64_t n = width - off;
            if (n > room) n = room;
            bool marker = (line == rows - 1) && (off + n >= width);
            uint8_t* h = arena + n_in_batch * kHdr;
            h[0] = 0x80;  // v=2
            h[1] = uint8_t((marker ? 0x80 : 0) | (pt & 0x7F));
            put16(h + 2, seq);
            put32(h + 4, ts);
            put32(h + 8, ssrc);
            h[12] = 0; h[13] = 0;                      // extended seq
            put16(h + 14, uint16_t(n));                // SRD length
            put16(h + 16, uint16_t(line));             // SRD line
            put16(h + 18, uint16_t(off));              // SRD offset
            iovs[n_in_batch][0] = {h, kHdr};
            iovs[n_in_batch][1] = {
                const_cast<uint8_t*>(frame + line * width + off), size_t(n)};
            msghdr& m = msgs[n_in_batch].msg_hdr;
            m = msghdr{};
            m.msg_name = &dest;
            m.msg_namelen = sizeof(dest);
            m.msg_iov = iovs[n_in_batch];
            m.msg_iovlen = 2;
            msgs[n_in_batch].msg_len = 0;
            ++n_in_batch;
            seq = uint16_t(seq + 1);
            off += n;
            // failure encoding: -(sent+1) — the caller must advance its
            // RTP sequence by `sent` so no stale seq is ever re-used
            if (n_in_batch == kBatch && !flush()) return -sent - 1;
        }
    }
    if (n_in_batch && !flush()) return -sent - 1;
    return sent;
}

// ---------------------------------------------------------- h264 i_pcm ----
// Native fast path for the in-repo lossless H.264 I_PCM encoder
// (io/h264_pcm.py — the always-available backend of the relay's encoder
// boundary, standing in for the reference's omxh264enc at
// OpenCVequalHist.cpp:308-332).  The per-frame work is pure byte
// assembly: macroblock sample fill (edge-replicated to the 16-px grid)
// and the §7.4.1.1 emulation-prevention escape scan over ~1.5x the frame
// size.  Python/numpy pays ~45 ms per 4K frame for this; here it is a
// strided memcpy pass plus a memchr-accelerated sequential state machine,
// GIL-free, and each slice band is independent so real multi-core hosts
// parallelize with std::thread (this container has one core).
//
// Bitstream layout is produced by the PYTHON side (slice heads with
// ue-coded first_mb_in_slice etc. are a few bytes and stay in the tested
// _BitWriter); C++ gets the head bytes verbatim and owns only the hot
// loop.  Output is REQUIRED to be byte-identical to the Python encoder —
// tests/test_native_pcm.py diffs the two paths across geometries.

namespace {

// Streaming emulation prevention (ITU-T H.264 §7.4.1.1): insert 0x03
// after any 00 00 pair followed by a byte <= 3.  State (the pending
// zero count, always 0..2) carries across feed() chunks, so the band is
// escaped in ONE pass while it is generated — no full-size unescaped
// scratch, half the memory traffic of a fill-then-escape design.
// memchr skips the (typical) long nonzero spans.
struct EscState {
    uint8_t* dst;
    size_t o = 0;
    int zeros = 0;

    explicit EscState(uint8_t* d) : dst(d) {}

    void feed(const uint8_t* src, size_t n) {
        size_t i = 0;
        while (i < n) {
            uint8_t b = src[i];
            if (zeros == 2 && b <= 3) {
                dst[o++] = 3;
                zeros = 0;
            }
            if (b != 0) {
                const uint8_t* z = static_cast<const uint8_t*>(
                    memchr(src + i, 0, n - i));
                size_t end = z ? size_t(z - src) : n;
                std::memcpy(dst + o, src + i, end - i);
                o += end - i;
                zeros = 0;
                i = end;
            } else {
                dst[o++] = 0;
                ++zeros;
                ++i;
            }
        }
    }
};

// Generate-and-escape one slice band: [head][MB ...] where every
// macroblock is [0x0D 0x00 prefix][256 luma][64 Cb][64 Cr], the FIRST
// MB's prefix/alignment living inside the head, and a trailing 0x80 —
// the exact byte stream of h264_pcm.encode_frame_pcm_slices, escaped on
// the fly.  Each MB is staged in an L1-resident 384-byte buffer
// (interior MBs take fixed-size copy loops; frame-edge MBs go through
// the clamped edge-replication path).
void pcm_encode_band(const uint8_t* nv12, size_t width, size_t height,
                     size_t mb_row0, size_t mb_rows, size_t mb_w,
                     const uint8_t* head, size_t head_len, uint8_t* out,
                     uint64_t* len_out) {
    EscState st(out);
    st.feed(head, head_len);
    const size_t half_h = height / 2, half_w = width / 2;
    static const uint8_t kPrefix[2] = {0x0D, 0x00};
    uint8_t buf[384];
    for (size_t r = 0; r < mb_rows; ++r) {
        const size_t row16 = (mb_row0 + r) * 16;
        const size_t row8 = (mb_row0 + r) * 8;
        const bool rows_ok = row16 + 16 <= height;  // => row8+8 <= half_h
        for (size_t c = 0; c < mb_w; ++c) {
            const size_t col0 = c * 16;
            if (rows_ok && col0 + 16 <= width) {
                const uint8_t* s = nv12 + row16 * width + col0;
                for (size_t y = 0; y < 16; ++y)
                    std::memcpy(buf + y * 16, s + y * width, 16);
                const uint8_t* u = nv12 + (height + row8) * width + col0;
                for (size_t y = 0; y < 8; ++y) {
                    const uint8_t* row = u + y * width;
                    for (size_t x = 0; x < 8; ++x) {
                        buf[256 + y * 8 + x] = row[2 * x];
                        buf[320 + y * 8 + x] = row[2 * x + 1];
                    }
                }
            } else {
                // frame edge: replicate the last row/column to the grid
                size_t avail = width - col0;  // col0 < width always
                if (avail > 16) avail = 16;
                for (size_t y = 0; y < 16; ++y) {
                    size_t srow = row16 + y;
                    if (srow >= height) srow = height - 1;
                    const uint8_t* s = nv12 + srow * width + col0;
                    std::memcpy(buf + y * 16, s, avail);
                    for (size_t x = avail; x < 16; ++x)
                        buf[y * 16 + x] = s[avail - 1];
                }
                for (size_t y = 0; y < 8; ++y) {
                    size_t srow = row8 + y;
                    if (srow >= half_h) srow = half_h - 1;
                    const uint8_t* s = nv12 + (height + srow) * width;
                    for (size_t x = 0; x < 8; ++x) {
                        size_t cx = c * 8 + x;
                        if (cx >= half_w) cx = half_w - 1;
                        buf[256 + y * 8 + x] = s[2 * cx];
                        buf[320 + y * 8 + x] = s[2 * cx + 1];
                    }
                }
            }
            if (r != 0 || c != 0) st.feed(kPrefix, 2);
            st.feed(buf, 384);
        }
    }
    const uint8_t tail = 0x80;  // rbsp_slice_trailing_bits
    st.feed(&tail, 1);
    *len_out = st.o;
}

}  // namespace

// Encode one NV12 frame as `nslices` I_PCM IDR slice NALs (no start
// codes).  heads_blob holds the nslices pre-built slice heads
// back-to-back (lengths in head_lens); row_bounds has nslices+1 MB-row
// boundaries.  Slice i is written at out + i*slice_stride, its length in
// out_lens[i].  threads > 1 runs slice bands on std::threads (each band
// is fully independent).  Returns 0, or -1 on bad args / a slice
// exceeding slice_stride (caller sizes stride to the 1.5x escape bound).
extern "C" int64_t fp_pcm_encode(const uint8_t* nv12, uint64_t width,
                                 uint64_t height, const uint8_t* heads_blob,
                                 const uint64_t* head_lens,
                                 const uint64_t* row_bounds,
                                 uint64_t nslices, int threads, uint8_t* out,
                                 uint64_t slice_stride, uint64_t* out_lens) {
    if (width == 0 || height == 0 || (width & 1) || (height & 1) ||
        nslices == 0)
        return -1;
    const size_t mb_w = (width + 15) / 16;
    std::vector<const uint8_t*> heads(nslices);
    {
        const uint8_t* p = heads_blob;
        for (uint64_t i = 0; i < nslices; ++i) {
            heads[i] = p;
            p += head_lens[i];
        }
    }
    std::atomic<int> failed{0};
    auto one = [&](uint64_t i) {
        size_t r0 = row_bounds[i], r1 = row_bounds[i + 1];
        size_t band = (r1 - r0) * mb_w;
        size_t head_len = head_lens[i];
        size_t raw = head_len - 2 + band * 386 + 1;
        if ((raw + 1) / 2 * 3 > slice_stride) {  // 1.5x escape worst case
            failed.store(1, std::memory_order_relaxed);
            return;
        }
        pcm_encode_band(nv12, width, height, r0, r1 - r0, mb_w, heads[i],
                        head_len, out + i * slice_stride, &out_lens[i]);
    };
    if (threads > 1 && nslices > 1) {
        std::vector<std::thread> pool;
        std::atomic<uint64_t> next{0};
        unsigned n_workers =
            std::min<uint64_t>(nslices, uint64_t(threads));
        for (unsigned w = 0; w < n_workers; ++w)
            pool.emplace_back([&] {
                for (uint64_t i = next.fetch_add(1); i < nslices;
                     i = next.fetch_add(1))
                    one(i);
            });
        for (auto& t : pool) t.join();
    } else {
        for (uint64_t i = 0; i < nslices; ++i) one(i);
    }
    return failed.load() ? -1 : 0;
}

// Assemble one COMPLETE Annex-B access unit into `out`:
// [prelude][00 00 00 01][slice0][00 00 00 01][slice1]... where `prelude`
// is the pre-escaped SPS+PPS block (start codes included) and each slice
// is generated+escaped in place.  This exists because the Python-side
// equivalent (`sc + nal` per slice, join, prepend prelude) costs three
// extra full-size copies — ~15 ms per 4K frame, 5x the encode itself.
// Single-threaded: slices are written back-to-back directly.  threads>1:
// slices land at stride offsets in parallel, then one compaction pass
// closes the gaps (still GIL-free; a real multi-core host wins overall).
// Returns the AU's total byte length, or -1 on bad args / overflow.
extern "C" int64_t fp_pcm_encode_au(
    const uint8_t* nv12, uint64_t width, uint64_t height,
    const uint8_t* prelude, uint64_t prelude_len, const uint8_t* heads_blob,
    const uint64_t* head_lens, const uint64_t* row_bounds, uint64_t nslices,
    int threads, uint8_t* out, uint64_t out_cap) {
    if (width == 0 || height == 0 || (width & 1) || (height & 1) ||
        nslices == 0)
        return -1;
    const size_t mb_w = (width + 15) / 16;
    static const uint8_t kStart[4] = {0, 0, 0, 1};
    std::vector<const uint8_t*> heads(nslices);
    {
        const uint8_t* p = heads_blob;
        for (uint64_t i = 0; i < nslices; ++i) {
            heads[i] = p;
            p += head_lens[i];
        }
    }
    // per-slice worst case (1.5x escape bound) sizes the layout
    std::vector<size_t> cap(nslices);
    size_t need = prelude_len;
    for (uint64_t i = 0; i < nslices; ++i) {
        size_t raw = head_lens[i] - 2 +
                     (row_bounds[i + 1] - row_bounds[i]) * mb_w * 386 + 1;
        cap[i] = 4 + (raw + 1) / 2 * 3;
        need += cap[i];
    }
    if (need > out_cap) return -1;
    std::memcpy(out, prelude, prelude_len);
    if (threads > 1 && nslices > 1) {
        std::vector<size_t> offs(nslices), lens(nslices);
        size_t off = prelude_len;
        for (uint64_t i = 0; i < nslices; ++i) {
            offs[i] = off;
            off += cap[i];
        }
        std::vector<std::thread> pool;
        std::atomic<uint64_t> next{0};
        unsigned n_workers = std::min<uint64_t>(nslices, uint64_t(threads));
        for (unsigned w = 0; w < n_workers; ++w)
            pool.emplace_back([&] {
                for (uint64_t i = next.fetch_add(1); i < nslices;
                     i = next.fetch_add(1)) {
                    uint8_t* dst = out + offs[i];
                    std::memcpy(dst, kStart, 4);
                    uint64_t n = 0;
                    pcm_encode_band(nv12, width, height, row_bounds[i],
                                    row_bounds[i + 1] - row_bounds[i], mb_w,
                                    heads[i], head_lens[i], dst + 4, &n);
                    lens[i] = size_t(n) + 4;
                }
            });
        for (auto& t : pool) t.join();
        size_t o = prelude_len + lens[0];  // slice 0 is already in place
        for (uint64_t i = 1; i < nslices; ++i) {
            std::memmove(out + o, out + offs[i], lens[i]);
            o += lens[i];
        }
        return int64_t(o);
    }
    size_t o = prelude_len;
    for (uint64_t i = 0; i < nslices; ++i) {
        std::memcpy(out + o, kStart, 4);
        uint64_t n = 0;
        pcm_encode_band(nv12, width, height, row_bounds[i],
                        row_bounds[i + 1] - row_bounds[i], mb_w, heads[i],
                        head_lens[i], out + o + 4, &n);
        o += size_t(n) + 4;
    }
    return int64_t(o);
}


// --------------------------------------------------------- h264 cavlc ----
// Native port of the compressed intra encoder (io/h264_cavlc.py — the
// rate-controlled stand-in for the reference's omxh264enc,
// OpenCVequalHist.cpp:308-332).  The Python module is the tested oracle
// (decoder-conformance proven through libavcodec); this port must be
// BYTE-IDENTICAL to it — tests/test_cavlc_native.py diffs the two
// across QPs, geometries, and pathological content.  Arithmetic notes:
// Python's // and >> floor like C++ arithmetic shifts on negatives
// (gcc), and every product here fits int32 except where noted.

namespace cavlc {

// CAVLC code tables, generated from io/h264_cavlc.py (themselves
// machine-checked prefix-free in tests/test_cavlc.py).
static const uint8_t kCt0Len[17][4] = {
    {1, 0, 0, 0},
    {6, 2, 0, 0},
    {8, 6, 3, 0},
    {9, 8, 7, 5},
    {10, 9, 8, 6},
    {11, 10, 9, 7},
    {13, 11, 10, 8},
    {13, 13, 11, 9},
    {13, 13, 13, 10},
    {14, 14, 13, 11},
    {14, 14, 14, 13},
    {15, 15, 14, 14},
    {15, 15, 15, 14},
    {16, 15, 15, 15},
    {16, 16, 16, 15},
    {16, 16, 16, 16},
    {16, 16, 16, 16},
};
static const uint16_t kCt0Val[17][4] = {
    {1, 0, 0, 0},
    {5, 1, 0, 0},
    {7, 4, 1, 0},
    {7, 6, 5, 3},
    {7, 6, 5, 3},
    {7, 6, 5, 4},
    {15, 6, 5, 4},
    {11, 14, 5, 4},
    {8, 10, 13, 4},
    {15, 14, 9, 4},
    {11, 10, 13, 12},
    {15, 14, 9, 12},
    {11, 10, 13, 8},
    {15, 1, 9, 12},
    {11, 14, 13, 8},
    {7, 10, 9, 12},
    {4, 6, 5, 8},
};
static const uint8_t kCt2Len[17][4] = {
    {2, 0, 0, 0},
    {6, 2, 0, 0},
    {6, 5, 3, 0},
    {7, 6, 6, 4},
    {8, 6, 6, 4},
    {8, 7, 7, 5},
    {9, 8, 8, 6},
    {11, 9, 9, 6},
    {11, 11, 11, 7},
    {12, 11, 11, 9},
    {12, 12, 12, 11},
    {12, 12, 12, 11},
    {13, 13, 13, 12},
    {13, 13, 13, 13},
    {13, 14, 13, 13},
    {14, 14, 14, 13},
    {14, 14, 14, 14},
};
static const uint16_t kCt2Val[17][4] = {
    {3, 0, 0, 0},
    {11, 2, 0, 0},
    {7, 7, 3, 0},
    {7, 10, 9, 5},
    {7, 6, 5, 4},
    {4, 6, 5, 6},
    {7, 6, 5, 8},
    {15, 6, 5, 4},
    {11, 14, 13, 4},
    {15, 10, 9, 4},
    {11, 14, 13, 12},
    {8, 10, 9, 8},
    {15, 14, 13, 12},
    {11, 10, 9, 12},
    {7, 11, 6, 8},
    {9, 8, 10, 1},
    {7, 6, 5, 4},
};
static const uint8_t kCt4Len[17][4] = {
    {4, 0, 0, 0},
    {6, 4, 0, 0},
    {6, 5, 4, 0},
    {6, 5, 5, 4},
    {7, 5, 5, 4},
    {7, 5, 5, 4},
    {7, 6, 6, 4},
    {7, 6, 6, 4},
    {8, 7, 7, 5},
    {8, 8, 7, 6},
    {9, 8, 8, 7},
    {9, 9, 8, 8},
    {9, 9, 9, 8},
    {10, 9, 9, 9},
    {10, 10, 10, 10},
    {10, 10, 10, 10},
    {10, 10, 10, 10},
};
static const uint16_t kCt4Val[17][4] = {
    {15, 0, 0, 0},
    {15, 14, 0, 0},
    {11, 15, 13, 0},
    {8, 12, 14, 12},
    {15, 10, 11, 11},
    {11, 8, 9, 10},
    {9, 14, 13, 9},
    {8, 10, 9, 8},
    {15, 14, 13, 13},
    {11, 14, 10, 12},
    {15, 10, 13, 12},
    {11, 14, 9, 12},
    {8, 10, 13, 8},
    {13, 7, 9, 12},
    {9, 12, 11, 10},
    {5, 8, 7, 6},
    {1, 4, 3, 2},
};
static const uint8_t kCtDcLen[5][4] = {
    {2, 0, 0, 0},
    {6, 1, 0, 0},
    {6, 6, 3, 0},
    {6, 7, 7, 6},
    {6, 8, 8, 7},
};
static const uint16_t kCtDcVal[5][4] = {
    {1, 0, 0, 0},
    {7, 1, 0, 0},
    {4, 6, 1, 0},
    {3, 3, 2, 5},
    {2, 3, 2, 0},
};
static const uint8_t kTzLen[16][16] = {
    {0},
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 0},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0},
    {6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0, 0, 0, 0},
    {6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0},
    {5, 5, 3, 2, 2, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};
static const uint16_t kTzVal[16][16] = {
    {0},
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0, 0, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0, 0, 0, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 1, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 1, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};
static const uint8_t kTzcLen[4][4] = {
    {0},
    {1, 2, 3, 3},
    {1, 2, 2, 0},
    {1, 1, 0, 0},
};
static const uint8_t kTzcVal[4][4] = {
    {0},
    {1, 1, 1, 0},
    {1, 1, 0, 0},
    {1, 0, 0, 0},
};
static const uint8_t kRbLen[8][15] = {
    {0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11},
};
static const uint8_t kRbVal[8][15] = {
    {0},
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 0, 1, 3, 2, 5, 4, 0, 0, 0, 0, 0, 0, 0, 0},
    {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1},
};

// forward/quant constants (Richardson; oracle _MF/_V/_POS_CLASS)
static const int kMF[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490},
                              {10082, 4194, 6554}, {9362, 3647, 5825},
                              {8192, 3355, 5243},  {7282, 2893, 4559}};
static const int kV[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                             {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
// coefficient-position class in a 4x4 (0: both-even, 1: both-odd, 2: rest)
static const int kPosClass[16] = {0, 2, 0, 2, 2, 1, 2, 1,
                                  0, 2, 0, 2, 2, 1, 2, 1};
static const int kQpc[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,
                             12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
                             24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
                             34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38,
                             39, 39, 39, 39};
static const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                9, 12, 13, 10, 7, 11, 14, 15};
// 4x4-block coding order inside a MB (bx, by), spec 6.4.3
static const int kBlockScan[16][2] = {
    {0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {3, 0}, {2, 1}, {3, 1},
    {0, 2}, {1, 2}, {0, 3}, {1, 3}, {2, 2}, {3, 2}, {2, 3}, {3, 3}};

// coded_block_pattern -> codeNum for Inter MBs (spec Table 9-4,
// ChromaArrayType=1; oracle io/h264_inter.py _CBP_INTER_CODENUM)
static const uint8_t kCbpInterCode[48] = {
    0,  2,  3,  7,  4,  8,  17, 13, 5,  18, 9,  14, 10, 15, 16, 11,
    1,  32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6,  24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12};

constexpr int kLevelClamp = 2063;  // oracle _LEVEL_CLAMP

struct BitW {
    uint8_t* buf;
    size_t cap;
    size_t nbytes = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool overflow = false;

    BitW(uint8_t* b, size_t c) : buf(b), cap(c) {}

    inline void u(uint32_t v, int n) {
        acc = (acc << n) | (uint64_t(v) & ((n >= 32) ? 0xffffffffull
                                                     : ((1ull << n) - 1)));
        nbits += n;
        while (nbits >= 8) {
            if (nbytes >= cap) {
                overflow = true;
                nbits = 0;
                return;
            }
            buf[nbytes++] = uint8_t(acc >> (nbits - 8));
            nbits -= 8;
        }
    }

    inline void ue(uint32_t value) {
        uint32_t code = value + 1;
        int n = 32 - __builtin_clz(code);
        u(code, 2 * n - 1);
    }

    inline void se(int value) {
        ue(value > 0 ? uint32_t(2 * value - 1) : uint32_t(-2 * value));
    }

    void trailing() {  // rbsp stop bit + zero alignment
        u(1, 1);
        if (nbits) u(0, 8 - nbits);
    }
};

// CAVLC residual_block (oracle _write_residual_block): coeffs in scan
// order low->high, n entries; nc = -1 for chroma DC.  Returns total_coeff.
static int write_res(BitW& w, const int32_t* coeffs, int n, int nc) {
    int idx[16], val[16], total = 0;
    for (int i = 0; i < n; ++i)
        if (coeffs[i] != 0) {
            idx[total] = i;
            val[total] = coeffs[i];
            ++total;
        }
    int t1s = 0;
    for (int k = total - 1; k >= 0 && t1s < 3; --k) {
        if (val[k] == 1 || val[k] == -1)
            ++t1s;
        else
            break;
    }
    if (nc == -1) {
        w.u(kCtDcVal[total][t1s], kCtDcLen[total][t1s]);
    } else if (nc < 2) {
        w.u(kCt0Val[total][t1s], kCt0Len[total][t1s]);
    } else if (nc < 4) {
        w.u(kCt2Val[total][t1s], kCt2Len[total][t1s]);
    } else if (nc < 8) {
        w.u(kCt4Val[total][t1s], kCt4Len[total][t1s]);
    } else {
        w.u(total == 0 ? 0b000011u : uint32_t(((total - 1) << 2) | t1s), 6);
    }
    if (total == 0) return 0;
    for (int k = total - 1; k >= total - t1s; --k)
        w.u(val[k] < 0 ? 1u : 0u, 1);
    int suffix_len = (total > 10 && t1s < 3) ? 1 : 0;
    bool first = true;
    for (int k = total - t1s - 1; k >= 0; --k) {
        int c = val[k];
        int level_code = c > 0 ? 2 * c - 2 : -2 * c - 1;
        if (first && t1s < 3) level_code -= 2;
        first = false;
        if (suffix_len == 0) {
            if (level_code < 14) {
                w.u(1, level_code + 1);
            } else if (level_code < 30) {
                w.u(1, 15);
                w.u(uint32_t(level_code - 14), 4);
            } else {
                w.u(1, 16);
                w.u(uint32_t(level_code - 30), 12);
            }
        } else {
            int prefix = level_code >> suffix_len;
            if (prefix < 15) {
                w.u(1, prefix + 1);
                w.u(uint32_t(level_code) & ((1u << suffix_len) - 1),
                    suffix_len);
            } else {
                w.u(1, 16);
                w.u(uint32_t(level_code - (15 << suffix_len)), 12);
            }
        }
        if (suffix_len == 0) suffix_len = 1;
        int ac = c < 0 ? -c : c;
        if (ac > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
    }
    int total_zeros = idx[total - 1] + 1 - total;
    if (total < n) {
        if (nc == -1)
            w.u(kTzcVal[total][total_zeros], kTzcLen[total][total_zeros]);
        else
            w.u(kTzVal[total][total_zeros], kTzLen[total][total_zeros]);
    }
    int zl = total_zeros;
    for (int k = total - 1; k >= 1; --k) {
        if (zl == 0) break;
        int run = idx[k] - idx[k - 1] - 1;
        int zi = zl < 7 ? zl : 7;
        w.u(kRbVal[zi][run], kRbLen[zi][run]);
        zl -= run;
    }
    return total;
}

// forward 4x4 core transform t = CF . blk . CF^T (row-major 4x4)
static inline void fwd4(const int32_t* b, int32_t* t) {
    int32_t m[16];
    for (int j = 0; j < 4; ++j) {  // left-multiply by CF (per column)
        int32_t b0 = b[j], b1 = b[4 + j], b2 = b[8 + j], b3 = b[12 + j];
        m[j] = b0 + b1 + b2 + b3;
        m[4 + j] = 2 * b0 + b1 - b2 - 2 * b3;
        m[8 + j] = b0 - b1 - b2 + b3;
        m[12 + j] = b0 - 2 * b1 + 2 * b2 - b3;
    }
    for (int i = 0; i < 4; ++i) {  // then right-multiply by CF^T
        int32_t a0 = m[i * 4], a1 = m[i * 4 + 1], a2 = m[i * 4 + 2],
                a3 = m[i * 4 + 3];
        t[i * 4] = a0 + a1 + a2 + a3;
        t[i * 4 + 1] = 2 * a0 + a1 - a2 - 2 * a3;
        t[i * 4 + 2] = a0 - a1 - a2 + a3;
        t[i * 4 + 3] = a0 - 2 * a1 + 2 * a2 - a3;
    }
}

// inverse 4x4 (oracle _inv4x4): rows then columns with >>1 taps
static inline void inv4(const int32_t* d, int32_t* g) {
    int32_t f[16];
    for (int i = 0; i < 4; ++i) {
        int32_t d0 = d[i * 4], d1 = d[i * 4 + 1], d2 = d[i * 4 + 2],
                d3 = d[i * 4 + 3];
        int32_t e0 = d0 + d2, e1 = d0 - d2;
        int32_t e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
        f[i * 4] = e0 + e3;
        f[i * 4 + 1] = e1 + e2;
        f[i * 4 + 2] = e1 - e2;
        f[i * 4 + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; ++j) {
        int32_t d0 = f[j], d1 = f[4 + j], d2 = f[8 + j], d3 = f[12 + j];
        int32_t e0 = d0 + d2, e1 = d0 - d2;
        int32_t e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
        g[j] = e0 + e3;
        g[4 + j] = e1 + e2;
        g[8 + j] = e1 - e2;
        g[12 + j] = e0 - e3;
    }
}

static inline int32_t qclamp(int32_t z) {
    return z > kLevelClamp ? kLevelClamp
                           : (z < -kLevelClamp ? -kLevelClamp : z);
}

// per-position forward quant (oracle _quant4x4), zeroing the DC slot
static inline void quant_ac(const int32_t* t, const int* mf16, int f,
                            int qbits, int32_t* z) {
    for (int i = 0; i < 16; ++i) {
        int32_t wv = t[i];
        int32_t a = wv < 0 ? -wv : wv;
        int32_t q = int32_t((int64_t(a) * mf16[i] + f) >> qbits);
        z[i] = qclamp(wv < 0 ? -q : (wv > 0 ? q : 0));
    }
    z[0] = 0;
}

struct FrameCtx {
    size_t w, h, mb_w, mb_h;
    int qp, qpc;
    int mfq[16], mfqc[16], vq[16], vqc[16];
    int fq, fqc, qbits, qbitsc;
    // reconstruction planes, +1 px top/left pad (uint8: always clipped)
    std::vector<uint8_t> ry, rcb, rcr;
    // total_coeff context planes, +1 pad
    std::vector<int8_t> lnnz, cbnnz, crnnz;

    FrameCtx(size_t W, size_t H, int QP)
        : w(W), h(H), mb_w(W / 16), mb_h(H / 16), qp(QP), qpc(kQpc[QP]) {
        for (int i = 0; i < 16; ++i) {
            mfq[i] = kMF[qp % 6][kPosClass[i]];
            mfqc[i] = kMF[qpc % 6][kPosClass[i]];
            vq[i] = kV[qp % 6][kPosClass[i]];
            vqc[i] = kV[qpc % 6][kPosClass[i]];
        }
        qbits = 15 + qp / 6;
        qbitsc = 15 + qpc / 6;
        fq = (1 << qbits) / 3;
        fqc = (1 << qbitsc) / 3;
        ry.assign((h + 1) * (w + 1), 0);
        rcb.assign((h / 2 + 1) * (w / 2 + 1), 0);
        rcr.assign((h / 2 + 1) * (w / 2 + 1), 0);
        lnnz.assign((mb_h * 4 + 1) * (mb_w * 4 + 1), 0);
        cbnnz.assign((mb_h * 2 + 1) * (mb_w * 2 + 1), 0);
        crnnz.assign((mb_h * 2 + 1) * (mb_w * 2 + 1), 0);
    }
};

static inline int nc_ctx(const int8_t* nnz, size_t stride, size_t by,
                         size_t bx, bool top_ok, bool left_ok) {
    if (left_ok && top_ok)
        return (nnz[by * stride + bx - 1] + nnz[(by - 1) * stride + bx] +
                1) >> 1;
    if (left_ok) return nnz[by * stride + bx - 1];
    if (top_ok) return nnz[(by - 1) * stride + bx];
    return 0;
}

static void encode_mb(FrameCtx& cx, BitW& w, size_t mby, size_t mbx,
                      const uint8_t* nv12, size_t first_mb_row) {
    const size_t W = cx.w, H = cx.h;
    // slices share no contexts: the band's first MB row is frame-top
    const bool top_ok = mby > first_mb_row, left_ok = mbx > 0;
    const size_t rstride = W + 1, cstride = W / 2 + 1;
    const size_t y0 = mby * 16 + 1, x0 = mbx * 16 + 1;

    // ---- luma DC-16x16 prediction (oracle _pred_dc16)
    int pred;
    if (top_ok && left_ok) {
        int s = 0;
        const uint8_t* t = &cx.ry[(y0 - 1) * rstride + x0];
        for (int i = 0; i < 16; ++i) s += t[i];
        for (int i = 0; i < 16; ++i) s += cx.ry[(y0 + i) * rstride + x0 - 1];
        pred = (s + 16) >> 5;
    } else if (top_ok) {
        int s = 0;
        const uint8_t* t = &cx.ry[(y0 - 1) * rstride + x0];
        for (int i = 0; i < 16; ++i) s += t[i];
        pred = (s + 8) >> 4;
    } else if (left_ok) {
        int s = 0;
        for (int i = 0; i < 16; ++i) s += cx.ry[(y0 + i) * rstride + x0 - 1];
        pred = (s + 8) >> 4;
    } else {
        pred = 128;
    }

    // ---- luma transforms + quant: DC candidate, plus HORIZONTAL
    // (each row replicates its left recon pixel) when left_ok — the
    // cheaper by the level-cost proxy wins (mirrors the Python oracle)
    int32_t predrow[16];   // per-row prediction of the chosen mode
    int32_t wdc[16];       // per-block t[0,0], laid out [by*4+bx]
    int32_t acz[16][16];   // quantized AC blocks [by*4+bx][raster]
    int32_t zdc[16];
    int predmode = 2;      // Intra_16x16_DC

    auto luma_levels = [&](const int32_t* prows, int32_t* wdc_,
                           int32_t (*acz_)[16], int32_t* zdc_) {
        int32_t resid[256];
        for (int y = 0; y < 16; ++y) {
            const uint8_t* s = nv12 + (mby * 16 + y) * W + mbx * 16;
            for (int x = 0; x < 16; ++x)
                resid[y * 16 + x] = int(s[x]) - prows[y];
        }
        for (int by = 0; by < 4; ++by)
            for (int bx = 0; bx < 4; ++bx) {
                int32_t blk[16], t[16];
                for (int r = 0; r < 4; ++r)
                    for (int c = 0; c < 4; ++c)
                        blk[r * 4 + c] =
                            resid[(by * 4 + r) * 16 + bx * 4 + c];
                fwd4(blk, t);
                wdc_[by * 4 + bx] = t[0];
                quant_ac(t, cx.mfq, cx.fq, cx.qbits, acz_[by * 4 + bx]);
            }
        // luma DC Hadamard (oracle: (H4 . wdc . H4) >> 1) + quant
        int32_t m[16], ydc[16];
        for (int j = 0; j < 4; ++j) {
            int32_t a = wdc_[j], b = wdc_[4 + j], c = wdc_[8 + j],
                    d = wdc_[12 + j];
            m[j] = a + b + c + d;
            m[4 + j] = a + b - c - d;
            m[8 + j] = a - b - c + d;
            m[12 + j] = a - b + c - d;
        }
        for (int i = 0; i < 4; ++i) {
            int32_t a = m[i * 4], b = m[i * 4 + 1], c = m[i * 4 + 2],
                    d = m[i * 4 + 3];
            ydc[i * 4] = (a + b + c + d) >> 1;
            ydc[i * 4 + 1] = (a + b - c - d) >> 1;
            ydc[i * 4 + 2] = (a - b - c + d) >> 1;
            ydc[i * 4 + 3] = (a - b + c - d) >> 1;
        }
        int f2 = 2 * cx.fq;
        for (int i = 0; i < 16; ++i) {
            int32_t v = ydc[i], a = v < 0 ? -v : v;
            int32_t q =
                int32_t((int64_t(a) * kMF[cx.qp % 6][0] + f2) >>
                        (cx.qbits + 1));
            zdc_[i] = qclamp(v < 0 ? -q : (v > 0 ? q : 0));
        }
    };
    auto lcost = [](const int32_t* zdc_, const int32_t (*acz_)[16]) {
        int64_t c = 0;
        for (int i = 0; i < 16; ++i) {
            int32_t a = zdc_[i] < 0 ? -zdc_[i] : zdc_[i];
            c += 2 * a + (a != 0);
        }
        for (int b = 0; b < 16; ++b)
            for (int i = 0; i < 16; ++i) {
                int32_t a = acz_[b][i] < 0 ? -acz_[b][i] : acz_[b][i];
                c += 2 * a + (a != 0);
            }
        return c;
    };

    for (int i = 0; i < 16; ++i) predrow[i] = pred;
    luma_levels(predrow, wdc, acz, zdc);
    if (left_ok) {
        int32_t hrow[16], wdc_h[16], acz_h[16][16], zdc_h[16];
        for (int i = 0; i < 16; ++i)
            hrow[i] = cx.ry[(y0 + i) * rstride + x0 - 1];
        luma_levels(hrow, wdc_h, acz_h, zdc_h);
        if (lcost(zdc_h, acz_h) < lcost(zdc, acz)) {
            predmode = 1;  // Intra_16x16_HORIZONTAL
            std::memcpy(predrow, hrow, sizeof(hrow));
            std::memcpy(wdc, wdc_h, sizeof(wdc));
            std::memcpy(acz, acz_h, sizeof(acz));
            std::memcpy(zdc, zdc_h, sizeof(zdc));
        }
    }
    bool cbp_luma = false;
    for (int b = 0; b < 16 && !cbp_luma; ++b)
        for (int i = 1; i < 16; ++i)
            if (acz[b][i]) {
                cbp_luma = true;
                break;
            }

    // ---- chroma (cb = comp 0, cr = comp 1)
    int32_t cwdc[2][4], cacz[2][4][16], czdc[2][4];
    int cpred[2][64];  // 8x8 prediction planes
    bool chroma_dc_nz = false, chroma_ac_nz = false;
    const size_t cy0 = mby * 8 + 1, cx0 = mbx * 8 + 1;
    for (int comp = 0; comp < 2; ++comp) {
        const std::vector<uint8_t>& rp = comp ? cx.rcr : cx.rcb;
        // _pred_dc_chroma: per-4x4-quadrant DC
        int tsum[2] = {0, 0}, lsum[2] = {0, 0};
        if (top_ok) {
            const uint8_t* t = &rp[(cy0 - 1) * cstride + cx0];
            for (int i = 0; i < 4; ++i) tsum[0] += t[i];
            for (int i = 4; i < 8; ++i) tsum[1] += t[i];
        }
        if (left_ok) {
            for (int i = 0; i < 4; ++i)
                lsum[0] += rp[(cy0 + i) * cstride + cx0 - 1];
            for (int i = 4; i < 8; ++i)
                lsum[1] += rp[(cy0 + i) * cstride + cx0 - 1];
        }
        auto fillq = [&](int qy, int qx, bool ut, bool ul) {
            int v;
            if (ut && ul)
                v = (tsum[qx] + lsum[qy] + 4) >> 3;
            else if (ut)
                v = (tsum[qx] + 2) >> 2;
            else if (ul)
                v = (lsum[qy] + 2) >> 2;
            else
                v = 128;
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x)
                    cpred[comp][(qy * 4 + y) * 8 + qx * 4 + x] = v;
        };
        fillq(0, 0, top_ok, left_ok);
        if (top_ok) fillq(0, 1, true, false);
        else fillq(0, 1, false, left_ok);
        if (left_ok) fillq(1, 0, false, true);
        else fillq(1, 0, top_ok, false);
        fillq(1, 1, top_ok, left_ok);

        int32_t cres[64];
        const uint8_t* uvbase = nv12 + H * W;
        for (int y = 0; y < 8; ++y) {
            const uint8_t* s = uvbase + (mby * 8 + y) * W + mbx * 16;
            for (int x = 0; x < 8; ++x)
                cres[y * 8 + x] =
                    int(s[2 * x + comp]) - cpred[comp][y * 8 + x];
        }
        for (int by = 0; by < 2; ++by)
            for (int bx = 0; bx < 2; ++bx) {
                int32_t blk[16], t[16];
                for (int r = 0; r < 4; ++r)
                    for (int c = 0; c < 4; ++c)
                        blk[r * 4 + c] = cres[(by * 4 + r) * 8 + bx * 4 + c];
                fwd4(blk, t);
                cwdc[comp][by * 2 + bx] = t[0];
                quant_ac(t, cx.mfqc, cx.fqc, cx.qbitsc,
                         cacz[comp][by * 2 + bx]);
                if (!chroma_ac_nz)
                    for (int i = 1; i < 16; ++i)
                        if (cacz[comp][by * 2 + bx][i]) {
                            chroma_ac_nz = true;
                            break;
                        }
            }
        // 2x2 Hadamard: f = H2 . cwdc . H2
        int32_t a = cwdc[comp][0], b = cwdc[comp][1], c = cwdc[comp][2],
                d = cwdc[comp][3];
        int32_t fdc[4] = {a + b + c + d, a - b + c - d, a + b - c - d,
                          a - b - c + d};
        int cf2 = 2 * cx.fqc;
        for (int i = 0; i < 4; ++i) {
            int32_t v = fdc[i], av = v < 0 ? -v : v;
            int32_t q =
                int32_t((int64_t(av) * kMF[cx.qpc % 6][0] + cf2) >>
                        (cx.qbitsc + 1));
            czdc[comp][i] = qclamp(v < 0 ? -q : (v > 0 ? q : 0));
            if (czdc[comp][i]) chroma_dc_nz = true;
        }
    }
    int cbp_chroma = chroma_ac_nz ? 2 : (chroma_dc_nz ? 1 : 0);

    // ---- syntax (oracle order exactly)
    w.ue(uint32_t(1 + predmode + 4 * cbp_chroma +
                  12 * (cbp_luma ? 1 : 0)));
    w.ue(0);  // intra_chroma_pred_mode: DC
    w.se(0);  // mb_qp_delta
    const size_t lstride = cx.mb_w * 4 + 1;
    const size_t nby0 = mby * 4 + 1, nbx0 = mbx * 4 + 1;
    {
        int nc = nc_ctx(cx.lnnz.data(), lstride, nby0, nbx0, top_ok,
                        left_ok);
        int32_t scan[16];
        for (int i = 0; i < 16; ++i) scan[i] = zdc[kZigzag[i]];
        write_res(w, scan, 16, nc);
    }
    if (cbp_luma) {
        for (int s = 0; s < 16; ++s) {
            int bx = kBlockScan[s][0], by = kBlockScan[s][1];
            bool t_ok = by == 0 ? top_ok : true;
            bool l_ok = bx == 0 ? left_ok : true;
            int nc = nc_ctx(cx.lnnz.data(), lstride, nby0 + by, nbx0 + bx,
                            t_ok, l_ok);
            int32_t scan[15];
            const int32_t* z = acz[by * 4 + bx];
            for (int i = 1; i < 16; ++i) scan[i - 1] = z[kZigzag[i]];
            int tc = write_res(w, scan, 15, nc);
            cx.lnnz[(nby0 + by) * lstride + nbx0 + bx] = int8_t(tc);
        }
    } else {
        for (int by = 0; by < 4; ++by)
            for (int bx = 0; bx < 4; ++bx)
                cx.lnnz[(nby0 + by) * lstride + nbx0 + bx] = 0;
    }
    if (cbp_chroma) {
        for (int comp = 0; comp < 2; ++comp) {
            int32_t lst[4] = {czdc[comp][0], czdc[comp][1], czdc[comp][2],
                              czdc[comp][3]};
            write_res(w, lst, 4, -1);
        }
    }
    const size_t cnstride = cx.mb_w * 2 + 1;
    const size_t cny0 = mby * 2 + 1, cnx0 = mbx * 2 + 1;
    for (int comp = 0; comp < 2; ++comp) {
        int8_t* cnnz = comp ? cx.crnnz.data() : cx.cbnnz.data();
        if (cbp_chroma == 2) {
            static const int order[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
            for (int s = 0; s < 4; ++s) {
                int bx = order[s][0], by = order[s][1];
                bool t_ok = by == 0 ? top_ok : true;
                bool l_ok = bx == 0 ? left_ok : true;
                int nc = nc_ctx(cnnz, cnstride, cny0 + by, cnx0 + bx, t_ok,
                                l_ok);
                int32_t scan[15];
                const int32_t* z = cacz[comp][by * 2 + bx];
                for (int i = 1; i < 16; ++i) scan[i - 1] = z[kZigzag[i]];
                int tc = write_res(w, scan, 15, nc);
                cnnz[(cny0 + by) * cnstride + cnx0 + bx] = int8_t(tc);
            }
        } else {
            for (int by = 0; by < 2; ++by)
                for (int bx = 0; bx < 2; ++bx)
                    cnnz[(cny0 + by) * cnstride + cnx0 + bx] = 0;
        }
    }

    // ---- reconstruction (must equal any conformant decoder)
    int32_t dcd[16];
    {
        // inverse Hadamard of zdc, then _luma_dc_dequant
        int32_t m[16], f4[16];
        for (int j = 0; j < 4; ++j) {
            int32_t a = zdc[j], b = zdc[4 + j], c = zdc[8 + j],
                    d = zdc[12 + j];
            m[j] = a + b + c + d;
            m[4 + j] = a + b - c - d;
            m[8 + j] = a - b - c + d;
            m[12 + j] = a - b + c - d;
        }
        for (int i = 0; i < 4; ++i) {
            int32_t a = m[i * 4], b = m[i * 4 + 1], c = m[i * 4 + 2],
                    d = m[i * 4 + 3];
            f4[i * 4] = a + b + c + d;
            f4[i * 4 + 1] = a + b - c - d;
            f4[i * 4 + 2] = a - b - c + d;
            f4[i * 4 + 3] = a - b + c - d;
        }
        int ls = 16 * kV[cx.qp % 6][0], k = cx.qp / 6;
        for (int i = 0; i < 16; ++i) {
            int64_t fv = f4[i];
            if (cx.qp >= 36)
                dcd[i] = int32_t((fv * ls) << (k - 6));
            else
                dcd[i] = int32_t((fv * ls + (1 << (5 - k))) >> (6 - k));
        }
    }
    for (int by = 0; by < 4; ++by)
        for (int bx = 0; bx < 4; ++bx) {
            int32_t d[16], r[16];
            const int32_t* z = acz[by * 4 + bx];
            for (int i = 0; i < 16; ++i)
                d[i] = z[i] * cx.vq[i] * (1 << (cx.qp / 6));
            d[0] = dcd[by * 4 + bx];
            inv4(d, r);
            uint8_t* dst = &cx.ry[(y0 + by * 4) * rstride + x0 + bx * 4];
            for (int rr = 0; rr < 4; ++rr)
                for (int cc = 0; cc < 4; ++cc) {
                    int v = ((r[rr * 4 + cc] + 32) >> 6) +
                            predrow[by * 4 + rr];
                    dst[rr * rstride + cc] =
                        uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
                }
        }
    for (int comp = 0; comp < 2; ++comp) {
        std::vector<uint8_t>& rp = comp ? cx.rcr : cx.rcb;
        // chroma DC: f = H2 . czdc . H2, then _chroma_dc_dequant
        int32_t a = czdc[comp][0], b = czdc[comp][1], c = czdc[comp][2],
                d0 = czdc[comp][3];
        int32_t fdc[4] = {a + b + c + d0, a - b + c - d0, a + b - c - d0,
                          a - b - c + d0};
        int ls = 16 * kV[cx.qpc % 6][0];
        int32_t cdcd[4];
        for (int i = 0; i < 4; ++i)
            cdcd[i] =
                int32_t(int64_t(fdc[i]) * ls * (1 << (cx.qpc / 6))) >> 5;
        for (int by = 0; by < 2; ++by)
            for (int bx = 0; bx < 2; ++bx) {
                int32_t d[16], r[16];
                const int32_t* z = cacz[comp][by * 2 + bx];
                for (int i = 0; i < 16; ++i)
                    d[i] = z[i] * cx.vqc[i] * (1 << (cx.qpc / 6));
                d[0] = cdcd[by * 2 + bx];
                inv4(d, r);
                uint8_t* dst =
                    &rp[(cy0 + by * 4) * cstride + cx0 + bx * 4];
                for (int rr = 0; rr < 4; ++rr)
                    for (int cc = 0; cc < 4; ++cc) {
                        int v = ((r[rr * 4 + cc] + 32) >> 6) +
                                cpred[comp][(by * 4 + rr) * 8 + bx * 4 + cc];
                        dst[rr * cstride + cc] =
                            uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
                    }
            }
    }
}

}  // namespace cavlc

// Encode one 16-aligned NV12 frame as a single-slice CAVLC IDR NAL.
// head_bits: the Python-built slice header, MSB-first packed, head_nbits
// long (NOT byte aligned — MB data continues bit-packed after it).
// RBSP goes into scratch, the §7.4.1.1-escaped NAL into out.  Returns
// the escaped length, or -1 on bad args / scratch overflow.
extern "C" int64_t fp_cavlc_encode(const uint8_t* nv12, uint64_t width,
                                   uint64_t height, int qp,
                                   const uint8_t* head_bits,
                                   uint64_t head_nbits, uint8_t* scratch,
                                   uint64_t scratch_cap, uint8_t* out,
                                   uint64_t out_cap) {
    if (width == 0 || height == 0 || (width % 16) || (height % 16) ||
        qp < 0 || qp > 51)
        return -1;
    cavlc::FrameCtx cx(width, height, qp);
    cavlc::BitW w(scratch, scratch_cap);
    uint64_t nfull = head_nbits / 8, rem = head_nbits % 8;
    for (uint64_t i = 0; i < nfull; ++i) w.u(head_bits[i], 8);
    if (rem) w.u(head_bits[nfull] >> (8 - rem), int(rem));
    for (size_t mby = 0; mby < cx.mb_h; ++mby)
        for (size_t mbx = 0; mbx < cx.mb_w; ++mbx)
            cavlc::encode_mb(cx, w, mby, mbx, nv12, 0);
    w.trailing();
    if (w.overflow) return -1;
    EscState esc(out);
    // escape bound: 3 bytes out per 2 in, +1 for a trailing escape
    if (w.nbytes / 2 * 3 + w.nbytes % 2 + 1 > out_cap) return -1;
    esc.feed(scratch, w.nbytes);
    return int64_t(esc.o);
}

// Multi-slice CAVLC encode: `nslices` independent MB-row-band IDR slice
// NALs (contexts reset per band, so bands run on std::threads — the
// reference's omxh264enc num-slices=8 analogue).  head_bits_blob holds
// the packed per-slice headers back to back, BYTE-padded per slice
// (head i starts at byte offs sum(ceil(head_nbits[j]/8))), lengths in
// BITS in head_nbits[].  Slice i's RBSP goes to scratch+i*stride, the
// escaped NAL to out+i*stride, its length into out_lens[i].  The
// reconstruction/nnz planes are shared — bands touch only their own
// rows (verified under TSAN in framepipe_stress.cpp).  Returns 0, or
// -1 on bad args / overflow.
extern "C" int64_t fp_cavlc_encode_slices(
    const uint8_t* nv12, uint64_t width, uint64_t height, int qp,
    const uint8_t* head_bits_blob, const uint64_t* head_nbits,
    const uint64_t* row_bounds, uint64_t nslices, int threads,
    uint8_t* scratch, uint64_t stride, uint8_t* out, uint64_t* out_lens) {
    if (width == 0 || height == 0 || (width % 16) || (height % 16) ||
        qp < 0 || qp > 51 || nslices == 0)
        return -1;
    cavlc::FrameCtx cx(width, height, qp);
    std::vector<const uint8_t*> heads(nslices);
    {
        const uint8_t* p = head_bits_blob;
        for (uint64_t i = 0; i < nslices; ++i) {
            heads[i] = p;
            p += (head_nbits[i] + 7) / 8;
        }
    }
    std::atomic<int> failed{0};
    auto one = [&](uint64_t i) {
        cavlc::BitW w(scratch + i * stride, stride / 3 * 2);
        uint64_t nfull = head_nbits[i] / 8, rem = head_nbits[i] % 8;
        for (uint64_t k = 0; k < nfull; ++k) w.u(heads[i][k], 8);
        if (rem) w.u(heads[i][nfull] >> (8 - rem), int(rem));
        for (size_t mby = row_bounds[i]; mby < row_bounds[i + 1]; ++mby)
            for (size_t mbx = 0; mbx < cx.mb_w; ++mbx)
                cavlc::encode_mb(cx, w, mby, mbx, nv12, row_bounds[i]);
        w.trailing();
        if (w.overflow) {
            failed.store(1, std::memory_order_relaxed);
            return;
        }
        EscState esc(out + i * stride);
        if (w.nbytes / 2 * 3 + w.nbytes % 2 + 1 > stride) {
            failed.store(1, std::memory_order_relaxed);
            return;
        }
        esc.feed(scratch + i * stride, w.nbytes);
        out_lens[i] = esc.o;
    };
    if (threads > 1 && nslices > 1) {
        std::vector<std::thread> pool;
        std::atomic<uint64_t> next{0};
        unsigned n_workers = std::min<uint64_t>(nslices, uint64_t(threads));
        for (unsigned w = 0; w < n_workers; ++w)
            pool.emplace_back([&] {
                for (uint64_t i = next.fetch_add(1); i < nslices;
                     i = next.fetch_add(1))
                    one(i);
            });
        for (auto& t : pool) t.join();
    } else {
        for (uint64_t i = 0; i < nslices; ++i) one(i);
    }
    return failed.load() ? -1 : 0;
}

namespace cavlc {

// Entropy-only MB encode from precomputed quantized levels (the TPU
// path: ops/h264_levels.py computes LevelArrays on-device, this writes
// the bitstream — the only CPU stage left).  Layouts are LevelArrays':
// zdc 16 raster, acz 16 blocks x 16 raster coeffs (DC slot zero),
// czdc 2 comps x 4, cacz 2 comps x 4 blocks x 16.  lnnz is the
// per-slice (4, mb_w*4+1) luma total_coeff context (+1 left pad);
// cbnnz/crnnz are (2, mb_w*2+1).  Must stay byte-identical to
// io/h264_cavlc.py encode_frame_from_levels (the Python oracle).
// chroma DC + AC residuals and their nC bookkeeping — shared by the
// intra and inter MB writers (identical syntax past the header part)
static void entropy_chroma(BitW& w, size_t mbx, size_t mb_w,
                           const int16_t* czdc, const int16_t* cacz,
                           int cbp_chroma, int8_t* cbnnz, int8_t* crnnz,
                           bool left_ok) {
    if (cbp_chroma) {
        for (int comp = 0; comp < 2; ++comp) {
            int32_t lst[4] = {czdc[comp * 4], czdc[comp * 4 + 1],
                              czdc[comp * 4 + 2], czdc[comp * 4 + 3]};
            write_res(w, lst, 4, -1);
        }
    }
    const size_t cstr = mb_w * 2 + 1;
    const size_t cnx0 = mbx * 2 + 1;
    for (int comp = 0; comp < 2; ++comp) {
        int8_t* cn = comp ? crnnz : cbnnz;
        if (cbp_chroma == 2) {
            static const int order[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
            for (int s = 0; s < 4; ++s) {
                int bx = order[s][0], by = order[s][1];
                bool l_ok = bx == 0 ? left_ok : true;
                int nc;
                if (by == 0)
                    nc = l_ok ? cn[cnx0 + bx - 1] : 0;
                else if (l_ok)
                    nc = (cn[by * cstr + cnx0 + bx - 1] +
                          cn[(by - 1) * cstr + cnx0 + bx] + 1) >> 1;
                else
                    nc = cn[(by - 1) * cstr + cnx0 + bx];
                const int16_t* z = cacz + (comp * 4 + by * 2 + bx) * 16;
                int32_t scan[15];
                for (int i = 1; i < 16; ++i) scan[i - 1] = z[kZigzag[i]];
                int tc = write_res(w, scan, 15, nc);
                cn[by * cstr + cnx0 + bx] = int8_t(tc);
            }
        } else {
            for (int by = 0; by < 2; ++by)
                for (int bx = 0; bx < 2; ++bx)
                    cn[by * cstr + cnx0 + bx] = 0;
        }
    }
}

static void entropy_mb(BitW& w, size_t mbx, size_t mb_w,
                       const int16_t* zdc, const int16_t* acz,
                       const int16_t* czdc, const int16_t* cacz,
                       int8_t* lnnz, int8_t* cbnnz, int8_t* crnnz,
                       int type_offset = 0, int predmode = 2,
                       int cmode = 0) {
    const bool left_ok = mbx > 0;
    bool cbp_luma = false;
    for (int i = 0; i < 256; ++i)
        if (acz[i]) {
            cbp_luma = true;
            break;
        }
    bool cac = false, cdc = false;
    for (int i = 0; i < 128; ++i)
        if (cacz[i]) {
            cac = true;
            break;
        }
    for (int i = 0; i < 8; ++i)
        if (czdc[i]) {
            cdc = true;
            break;
        }
    const int cbp_chroma = cac ? 2 : (cdc ? 1 : 0);
    w.ue(uint32_t(type_offset + 1 + predmode + 4 * cbp_chroma +
                  12 * (cbp_luma ? 1 : 0)));
    w.ue(uint32_t(cmode));  // intra_chroma_pred_mode (0 DC, 1 HOR)
    w.se(0);  // mb_qp_delta
    const size_t lstr = mb_w * 4 + 1;
    const size_t nbx0 = mbx * 4 + 1;
    {
        // luma DC: nC as for 4x4 block 0 (slice top row: no top nbr)
        int nc = left_ok ? lnnz[nbx0 - 1] : 0;
        int32_t scan[16];
        for (int i = 0; i < 16; ++i) scan[i] = zdc[kZigzag[i]];
        write_res(w, scan, 16, nc);
    }
    if (cbp_luma) {
        for (int s = 0; s < 16; ++s) {
            int bx = kBlockScan[s][0], by = kBlockScan[s][1];
            bool l_ok = bx == 0 ? left_ok : true;
            int nc;
            if (by == 0)
                nc = l_ok ? lnnz[nbx0 + bx - 1] : 0;
            else if (l_ok)
                nc = (lnnz[by * lstr + nbx0 + bx - 1] +
                      lnnz[(by - 1) * lstr + nbx0 + bx] + 1) >> 1;
            else
                nc = lnnz[(by - 1) * lstr + nbx0 + bx];
            const int16_t* z = acz + (by * 4 + bx) * 16;
            int32_t scan[15];
            for (int i = 1; i < 16; ++i) scan[i - 1] = z[kZigzag[i]];
            int tc = write_res(w, scan, 15, nc);
            lnnz[by * lstr + nbx0 + bx] = int8_t(tc);
        }
    } else {
        for (int by = 0; by < 4; ++by)
            for (int bx = 0; bx < 4; ++bx)
                lnnz[by * lstr + nbx0 + bx] = 0;
    }
    entropy_chroma(w, mbx, mb_w, czdc, cacz, cbp_chroma, cbnnz, crnnz,
                   left_ok);
}

// coded_block_pattern me(v) mapping for Intra_4x4 (spec Table 9-4,
// ChromaArrayType = 1): cbp -> codeNum.  The inverse of the decode
// table in io/h264_cavlc.py (_CBP_INTRA_CODE) — validated by the
// lavc-proven byte-identity of the Python twin.
static const uint8_t kCbpIntraCode[48] = {
    3, 29, 30, 17, 31, 18, 37, 8, 32, 38, 19, 9, 20, 10, 11, 2,
    16, 33, 34, 21, 35, 22, 39, 4, 36, 40, 23, 5, 24, 6, 7, 1,
    41, 42, 43, 25, 44, 26, 46, 12, 45, 47, 27, 13, 28, 14, 15, 0};

// z index of the 4x4 block at (bx, by) in the MB (inverse kBlockScan)
static const int kZOf[4][4] = {   // [by][bx]
    {0, 1, 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15}};

// Intra_4x4 MB from precomputed levels: acz slots carry FULL
// 16-coeff blocks (no luma DC block); ``zm`` the 16 chosen modes in
// z-scan order; predicted-mode derivation under the one-row-slice
// collapse (top MB row is another slice) with the left MB context.
// Mirrors io/h264_cavlc.py encode_frame_from_levels' i4 branch.
static void entropy_i4_mb(BitW& w, size_t mbx, size_t mb_w,
                          const int16_t* acz, const int16_t* czdc,
                          const int16_t* cacz, int8_t* lnnz,
                          int8_t* cbnnz, int8_t* crnnz,
                          const int16_t* zm, int cmode,
                          bool prev_is_i4, const int prev_m3[4]) {
    const bool left_ok = mbx > 0;
    int cbpl = 0;
    for (int q = 0; q < 4; ++q) {
        for (int s = 4 * q; s < 4 * q + 4; ++s) {
            int bx = kBlockScan[s][0], by = kBlockScan[s][1];
            const int16_t* z = acz + (by * 4 + bx) * 16;
            bool nz = false;
            for (int i = 0; i < 16; ++i)
                if (z[i]) {
                    nz = true;
                    break;
                }
            if (nz) {
                cbpl |= 1 << q;
                break;
            }
        }
    }
    bool cac = false, cdc = false;
    for (int i = 0; i < 128; ++i)
        if (cacz[i]) {
            cac = true;
            break;
        }
    for (int i = 0; i < 8; ++i)
        if (czdc[i]) {
            cdc = true;
            break;
        }
    const int cbp_chroma = cac ? 2 : (cdc ? 1 : 0);
    const int cbp = cbpl | (cbp_chroma << 4);
    w.ue(0);                    // mb_type: I_4x4
    for (int z = 0; z < 16; ++z) {
        int bx = kBlockScan[z][0], by = kBlockScan[z][1];
        int predm;
        if (by == 0) {
            predm = 2;          // top neighbor: another slice
        } else {
            int mb_ = int(zm[kZOf[by - 1][bx]]);
            if (bx > 0) {
                int ma = int(zm[kZOf[by][bx - 1]]);
                predm = ma < mb_ ? ma : mb_;
            } else if (left_ok) {
                int ma = prev_is_i4 ? prev_m3[by] : 2;
                predm = ma < mb_ ? ma : mb_;
            } else {
                predm = 2;
            }
        }
        int m = int(zm[z]);
        if (m == predm) {
            w.u(1, 1);          // prev_intra4x4_pred_mode_flag
        } else {
            w.u(0, 1);
            w.u(uint32_t(m < predm ? m : m - 1), 3);
        }
    }
    w.ue(uint32_t(cmode));      // intra_chroma_pred_mode
    w.ue(kCbpIntraCode[cbp]);   // coded_block_pattern, me(v) intra
    if (cbp) w.se(0);           // mb_qp_delta
    const size_t lstr = mb_w * 4 + 1;
    const size_t nbx0 = mbx * 4 + 1;
    for (int z = 0; z < 16; ++z) {
        int bx = kBlockScan[z][0], by = kBlockScan[z][1];
        if (!((cbpl >> (z >> 2)) & 1)) {
            lnnz[by * lstr + nbx0 + bx] = 0;
            continue;
        }
        bool l_ok = bx == 0 ? left_ok : true;
        int nc;
        if (by == 0)
            nc = l_ok ? lnnz[nbx0 + bx - 1] : 0;
        else if (l_ok)
            nc = (lnnz[by * lstr + nbx0 + bx - 1] +
                  lnnz[(by - 1) * lstr + nbx0 + bx] + 1) >> 1;
        else
            nc = lnnz[(by - 1) * lstr + nbx0 + bx];
        const int16_t* z16 = acz + (by * 4 + bx) * 16;
        int32_t scan[16];
        for (int i = 0; i < 16; ++i) scan[i] = z16[kZigzag[i]];
        int tc = write_res(w, scan, 16, nc);
        lnnz[by * lstr + nbx0 + bx] = int8_t(tc);
    }
    entropy_chroma(w, mbx, mb_w, czdc, cacz, cbp_chroma, cbnnz, crnnz,
                   left_ok);
}

// cbp of an inter MB from precomputed levels: acz holds FULL 4x4
// blocks (DC included); CBP luma is one bit per 8x8 quadrant.
static int inter_cbp(const int16_t* acz, const int16_t* czdc,
                     const int16_t* cacz) {
    int cbp_luma = 0;
    for (int b = 0; b < 16; ++b) {
        const int16_t* z = acz + b * 16;
        for (int i = 0; i < 16; ++i)
            if (z[i]) {
                int bx = b % 4, by = b / 4;
                cbp_luma |= 1 << ((bx >= 2 ? 1 : 0) + (by >= 2 ? 2 : 0));
                break;
            }
    }
    bool cac = false, cdc = false;
    for (int i = 0; i < 128; ++i)
        if (cacz[i]) {
            cac = true;
            break;
        }
    for (int i = 0; i < 8; ++i)
        if (czdc[i]) {
            cdc = true;
            break;
        }
    const int cbp_chroma = cac ? 2 : (cdc ? 1 : 0);
    return cbp_luma | (cbp_chroma << 4);
}

// shared tail of every coded inter MB: cbp, mb_qp_delta, quadrant-
// gated full-block luma residuals, chroma (mirrors the Python
// writers' shared section in encode_frame_p_from_levels).
static void entropy_p_tail(BitW& w, size_t mbx, size_t mb_w,
                           const int16_t* acz, const int16_t* czdc,
                           const int16_t* cacz, int8_t* lnnz,
                           int8_t* cbnnz, int8_t* crnnz, int cbp) {
    const bool left_ok = mbx > 0;
    const int cbp_luma = cbp & 15;
    const int cbp_chroma = cbp >> 4;
    w.ue(kCbpInterCode[cbp]);
    const size_t lstr = mb_w * 4 + 1;
    const size_t nbx0 = mbx * 4 + 1;
    const size_t cstr = mb_w * 2 + 1;
    const size_t cnx0 = mbx * 2 + 1;
    if (!cbp) {
        for (int by = 0; by < 4; ++by)
            for (int bx = 0; bx < 4; ++bx)
                lnnz[by * lstr + nbx0 + bx] = 0;
        for (int by = 0; by < 2; ++by)
            for (int bx = 0; bx < 2; ++bx) {
                cbnnz[by * cstr + cnx0 + bx] = 0;
                crnnz[by * cstr + cnx0 + bx] = 0;
            }
        return;
    }
    w.se(0);   // mb_qp_delta (cbp != 0)
    for (int s = 0; s < 16; ++s) {
        int bx = kBlockScan[s][0], by = kBlockScan[s][1];
        int q = (bx >= 2 ? 1 : 0) + (by >= 2 ? 2 : 0);
        if (!((cbp_luma >> q) & 1)) {
            lnnz[by * lstr + nbx0 + bx] = 0;
            continue;
        }
        bool l_ok = bx == 0 ? left_ok : true;
        int nc;
        if (by == 0)
            nc = l_ok ? lnnz[nbx0 + bx - 1] : 0;
        else if (l_ok)
            nc = (lnnz[by * lstr + nbx0 + bx - 1] +
                  lnnz[(by - 1) * lstr + nbx0 + bx] + 1) >> 1;
        else
            nc = lnnz[(by - 1) * lstr + nbx0 + bx];
        const int16_t* z = acz + (by * 4 + bx) * 16;
        int32_t scan[16];
        for (int i = 0; i < 16; ++i) scan[i] = z[kZigzag[i]];
        int tc = write_res(w, scan, 16, nc);
        lnnz[by * lstr + nbx0 + bx] = int8_t(tc);
    }
    entropy_chroma(w, mbx, mb_w, czdc, cacz, cbp_chroma, cbnnz, crnnz,
                   left_ok);
}

// Inter (P_L0_16x16) MB from precomputed levels.  mvd_x / mvd_y are
// quarter-pel motion vector differences (0 in the zero-motion
// configuration).  A cbp==0 MB (possible when the device search
// picked a non-predictor MV whose residual quantized away) has no
// mb_qp_delta and no residual syntax.  Mirrors io/h264_inter.py
// encode_frame_p_from_levels.
static void entropy_p_mb(BitW& w, size_t mbx, size_t mb_w,
                         const int16_t* acz, const int16_t* czdc,
                         const int16_t* cacz, int8_t* lnnz,
                         int8_t* cbnnz, int8_t* crnnz,
                         int32_t mvd_x, int32_t mvd_y,
                         int32_t ref_idx, int active_refs) {
    const int cbp = inter_cbp(acz, czdc, cacz);
    w.ue(0);       // mb_type: P_L0_16x16
    if (active_refs == 2)
        w.u(uint32_t(1 - ref_idx), 1);  // te(v): single INVERTED bit
    else if (active_refs > 2)
        w.ue(uint32_t(ref_idx));
    w.se(mvd_x);   // mvd_l0 x
    w.se(mvd_y);   // mvd_l0 y
    entropy_p_tail(w, mbx, mb_w, acz, czdc, cacz, lnnz, cbnnz, crnnz,
                   cbp);
}

// ---- partitioned P MBs (16x8 / 8x16 / 8x8 with per-partition mvd
// and, with refs > 1, per-partition te(v) ref_idx) — the C++ twin of
// the Python from-levels parts path (encode_frame_p_from_levels with
// pmode) and the _mvp_parts reference-aware predictor.

struct MvCand {
    int32_t y, x, ref;
    bool avail;
};

// spec 8.4.1.3.1 general process under the one-row-slice collapse:
// copy rule (B, C unavailable and A available -> raw mvA), then the
// exactly-one-refIdx-match rule, else the component median.
static void mvp_general(MvCand A, MvCand B, MvCand C, int myref,
                        int32_t* oy, int32_t* ox) {
    int32_t ey[3], ex[3], er[3];
    const MvCand* nn[3] = {&A, &B, &C};
    for (int k = 0; k < 3; ++k) {
        ey[k] = nn[k]->avail ? nn[k]->y : 0;
        ex[k] = nn[k]->avail ? nn[k]->x : 0;
        er[k] = nn[k]->avail ? nn[k]->ref : -1;
    }
    if (!B.avail && !C.avail && A.avail) {
        *oy = ey[0];
        *ox = ex[0];
        return;
    }
    int nm = 0, mi = -1;
    for (int k = 0; k < 3; ++k)
        if (er[k] == myref) {
            ++nm;
            mi = k;
        }
    if (nm == 1) {
        *oy = ey[mi];
        *ox = ex[mi];
        return;
    }
    auto med = [](int32_t a, int32_t b, int32_t c) {
        return std::max(std::min(a, b), std::min(std::max(a, b), c));
    };
    *oy = med(ey[0], ey[1], ey[2]);
    *ox = med(ex[0], ex[1], ex[2]);
}

// the reference-aware per-partition predictor (io/h264_inter.py
// _mvp_parts — see its docstring for the case derivation)
static void mvp_parts(int pidx, int pmode, bool left_avail,
                      bool left_inter, const int32_t lq1[2],
                      const int32_t lq3[2], int lr1, int lr3,
                      const int16_t* mv4, const int16_t* ref4,
                      int myref, int32_t* oy, int32_t* ox) {
    MvCand a1{left_inter ? lq1[0] : 0, left_inter ? lq1[1] : 0,
              left_inter ? lr1 : -1, left_avail};
    MvCand a3{left_inter ? lq3[0] : 0, left_inter ? lq3[1] : 0,
              left_inter ? lr3 : -1, left_avail};
    auto ownn = [&](int q) {
        return MvCand{int32_t(mv4[q * 2]), int32_t(mv4[q * 2 + 1]),
                      ref4 ? int32_t(ref4[q]) : 0, true};
    };
    const MvCand U{0, 0, -1, false};
    if (pmode == 0) {
        mvp_general(a1, U, U, myref, oy, ox);
    } else if (pmode == 1) {           // 16x8: partitions (q0, q2)
        if (pidx == 0) {
            mvp_general(a1, U, U, myref, oy, ox);
        } else if (a3.avail && a3.ref == myref) {  // directional A
            *oy = a3.y;
            *ox = a3.x;
        } else {
            mvp_general(a3, ownn(0), a1, myref, oy, ox);
        }
    } else if (pmode == 2) {           // 8x16: partitions (q0, q1)
        if (pidx == 0) {
            if (a1.avail && a1.ref == myref) {     // directional A
                *oy = a1.y;
                *ox = a1.x;
            } else {
                mvp_general(a1, U, U, myref, oy, ox);
            }
        } else {
            mvp_general(ownn(0), U, U, myref, oy, ox);
        }
    } else {                           // P_8x8 sub-partitions q0..q3
        if (pidx == 0)
            mvp_general(a1, U, U, myref, oy, ox);
        else if (pidx == 1)
            mvp_general(ownn(0), U, U, myref, oy, ox);
        else if (pidx == 2)
            mvp_general(a3, ownn(0), ownn(1), myref, oy, ox);
        else
            mvp_general(ownn(2), ownn(1), ownn(0), myref, oy, ox);
    }
}

// representative quadrant of each partition, per pmode
// (io/h264_inter.py _PART_QUADS: quads[0])
static const int kPartReps[4][4] = {
    {0, 0, 0, 0}, {0, 2, 0, 0}, {0, 1, 0, 0}, {0, 1, 2, 3}};
static const int kPartN[4] = {1, 2, 2, 4};

static void entropy_p_mb_parts(
    BitW& w, size_t mbx, size_t mb_w, const int16_t* acz,
    const int16_t* czdc, const int16_t* cacz, int8_t* lnnz,
    int8_t* cbnnz, int8_t* crnnz, int pmode, const int16_t* mv4,
    const int16_t* ref4, int active_refs, bool left_avail,
    bool left_inter, const int32_t lq1[2], const int32_t lq3[2],
    int lr1, int lr3) {
    const int cbp = inter_cbp(acz, czdc, cacz);
    w.ue(uint32_t(pmode));   // mb_type: 16x16 / 16x8 / 8x16 / 8x8
    if (pmode == 3)
        for (int k = 0; k < 4; ++k) w.ue(0);  // sub_mb_type P_L0_8x8
    if (active_refs > 1) {
        for (int p = 0; p < kPartN[pmode]; ++p) {
            int r = ref4 ? int(ref4[kPartReps[pmode][p]]) : 0;
            if (active_refs == 2)
                w.u(uint32_t(1 - r), 1);    // te(v): inverted bit
            else
                w.ue(uint32_t(r));
        }
    }
    for (int p = 0; p < kPartN[pmode]; ++p) {
        const int q0 = kPartReps[pmode][p];
        const int myref = ref4 ? int(ref4[q0]) : 0;
        int32_t py, px;
        mvp_parts(p, pmode, left_avail, left_inter, lq1, lq3, lr1,
                  lr3, mv4, ref4, myref, &py, &px);
        w.se(int32_t(mv4[q0 * 2 + 1]) - px);   // x first (7.3.5.1)
        w.se(int32_t(mv4[q0 * 2]) - py);
    }
    entropy_p_tail(w, mbx, mb_w, acz, czdc, cacz, lnnz, cbnnz, crnnz,
                   cbp);
}

}  // namespace cavlc

// Entropy-code precomputed quantized levels (LevelArrays layouts, one
// IDR slice NAL per MB row — the TPU encode path's CPU stage).  Heads
// as in fp_cavlc_encode_slices (packed bits, byte-padded per slice).
// Slice i's RBSP goes to scratch+i*stride, the escaped NAL to
// out+i*stride, its length into out_lens[i].  Returns 0, or -1 on bad
// args / overflow.
// ``i4modes``/``cmode`` (nullable trailing args; legacy call shape
// still binds): per-MB Intra_4x4 block modes (z-scan (mb, 16), used
// where imode[mb] == 0 — acz slots then carry FULL 16-coeff blocks)
// and the per-MB intra_chroma_pred_mode plane (0 DC / 1 HORIZONTAL).
extern "C" int64_t fp_cavlc_entropy_rows(
    const int16_t* zdc, const int16_t* acz, const int16_t* czdc,
    const int16_t* cacz, const int16_t* imode, uint64_t mb_h,
    uint64_t mb_w, const uint8_t* head_bits_blob,
    const uint64_t* head_nbits, int threads, uint8_t* scratch,
    uint64_t stride, uint8_t* out, uint64_t* out_lens,
    const int16_t* i4modes, const int16_t* cmode) {
    if (mb_h == 0 || mb_w == 0) return -1;
    std::vector<const uint8_t*> heads(mb_h);
    {
        const uint8_t* p = head_bits_blob;
        for (uint64_t i = 0; i < mb_h; ++i) {
            heads[i] = p;
            p += (head_nbits[i] + 7) / 8;
        }
    }
    std::atomic<int> failed{0};
    const size_t lstr = mb_w * 4 + 1, cstr = mb_w * 2 + 1;
    auto one = [&](uint64_t i, int8_t* lnnz, int8_t* cbnnz,
                   int8_t* crnnz) {
        cavlc::BitW w(scratch + i * stride, stride / 3 * 2);
        uint64_t nfull = head_nbits[i] / 8, rem = head_nbits[i] % 8;
        for (uint64_t k = 0; k < nfull; ++k) w.u(heads[i][k], 8);
        if (rem) w.u(heads[i][nfull] >> (8 - rem), int(rem));
        std::memset(lnnz, 0, 4 * lstr);
        std::memset(cbnnz, 0, 2 * cstr);
        std::memset(crnnz, 0, 2 * cstr);
        bool prev_is_i4 = false;
        int prev_m3[4] = {2, 2, 2, 2};
        for (uint64_t mbx = 0; mbx < mb_w; ++mbx) {
            uint64_t mb = i * mb_w + mbx;
            const int cm = cmode ? int(cmode[mb]) : 0;
            const int pm = imode ? int(imode[mb]) : 2;
            if (i4modes && pm == 0) {
                const int16_t* zm = i4modes + mb * 16;
                cavlc::entropy_i4_mb(w, mbx, mb_w, acz + mb * 256,
                                     czdc + mb * 8, cacz + mb * 128,
                                     lnnz, cbnnz, crnnz, zm, cm,
                                     prev_is_i4, prev_m3);
                prev_is_i4 = true;
                for (int by = 0; by < 4; ++by)
                    prev_m3[by] = int(zm[cavlc::kZOf[by][3]]);
            } else {
                cavlc::entropy_mb(w, mbx, mb_w, zdc + mb * 16,
                                  acz + mb * 256, czdc + mb * 8,
                                  cacz + mb * 128, lnnz, cbnnz, crnnz,
                                  /*type_offset=*/0, /*predmode=*/pm,
                                  /*cmode=*/cm);
                prev_is_i4 = false;
            }
        }
        w.trailing();
        if (w.overflow) {
            failed.store(1, std::memory_order_relaxed);
            return;
        }
        EscState esc(out + i * stride);
        if (w.nbytes / 2 * 3 + w.nbytes % 2 + 1 > stride) {
            failed.store(1, std::memory_order_relaxed);
            return;
        }
        esc.feed(scratch + i * stride, w.nbytes);
        out_lens[i] = esc.o;
    };
    if (threads > 1 && mb_h > 1) {
        std::vector<std::thread> pool;
        std::atomic<uint64_t> next{0};
        unsigned n_workers = std::min<uint64_t>(mb_h, uint64_t(threads));
        for (unsigned t = 0; t < n_workers; ++t)
            pool.emplace_back([&] {
                std::vector<int8_t> ln(4 * lstr), cbn(2 * cstr),
                    crn(2 * cstr);
                for (uint64_t i = next.fetch_add(1); i < mb_h;
                     i = next.fetch_add(1))
                    one(i, ln.data(), cbn.data(), crn.data());
            });
        for (auto& t : pool) t.join();
    } else {
        std::vector<int8_t> ln(4 * lstr), cbn(2 * cstr), crn(2 * cstr);
        for (uint64_t i = 0; i < mb_h; ++i)
            one(i, ln.data(), cbn.data(), crn.data());
    }
    return failed.load() ? -1 : 0;
}

// P-frame variant: entropy-code precomputed chosen-mode levels
// (PLevelArrays layouts + per-MB mode plane: 0 P_Skip / 1 P_L0_16x16 /
// 2 I_16x16) into one P slice NAL per MB row, with mb_skip_run
// accounting.  ``mv`` is the (mb_h*mb_w, 2) (dy, dx) QUARTER-pel MV
// field from the device motion search, or null for zero motion; the
// MV predictor is the one-row-slice left-only rule (mvp = the left
// MB's MV when it is inter — P_Skip rows carry (0,0) — reset per row
// and after intra MBs); mvd = mv - mvp directly (the field is already
// in the quarter-pel wire unit).  ``ref`` (nullable) + active_refs
// carry the multi-reference configuration: te(v)-coded ref_idx_l0 per
// inter MB when active_refs > 1.  Byte-identical to io/h264_inter.py
// encode_frame_p_from_levels (the Python oracle).  Same scratch/out
// discipline as fp_cavlc_entropy_rows.
// ``pmode``/``mv4``/``ref4`` (all nullable; trailing args so the
// legacy call shape still binds) select the PARTITIONED write path:
// per-MB partition mode in {0..3}, the quadrant-major (mb_h*mb_w, 4,
// 2) quarter-pel MV field, and (refs > 1) the (mb_h*mb_w, 4)
// per-quadrant reference field — the C++ twin of the Python parts
// path with the reference-aware _mvp_parts predictor.
extern "C" int64_t fp_cavlc_entropy_rows_p(
    const int16_t* mode, const int16_t* zdc, const int16_t* acz,
    const int16_t* czdc, const int16_t* cacz, const int16_t* mv,
    const int16_t* ref, int active_refs,
    uint64_t mb_h, uint64_t mb_w, const uint8_t* head_bits_blob,
    const uint64_t* head_nbits, int threads, uint8_t* scratch,
    uint64_t stride, uint8_t* out, uint64_t* out_lens,
    const int16_t* pmode, const int16_t* mv4, const int16_t* ref4) {
    if (mb_h == 0 || mb_w == 0) return -1;
    std::vector<const uint8_t*> heads(mb_h);
    {
        const uint8_t* p = head_bits_blob;
        for (uint64_t i = 0; i < mb_h; ++i) {
            heads[i] = p;
            p += (head_nbits[i] + 7) / 8;
        }
    }
    std::atomic<int> failed{0};
    const size_t lstr = mb_w * 4 + 1, cstr = mb_w * 2 + 1;
    auto one = [&](uint64_t i, int8_t* lnnz, int8_t* cbnnz,
                   int8_t* crnnz) {
        cavlc::BitW w(scratch + i * stride, stride / 3 * 2);
        uint64_t nfull = head_nbits[i] / 8, rem = head_nbits[i] % 8;
        for (uint64_t k = 0; k < nfull; ++k) w.u(heads[i][k], 8);
        if (rem) w.u(heads[i][nfull] >> (8 - rem), int(rem));
        std::memset(lnnz, 0, 4 * lstr);
        std::memset(cbnnz, 0, 2 * cstr);
        std::memset(crnnz, 0, 2 * cstr);
        uint32_t skip_run = 0;
        bool left_inter = false;     // left MB inter (incl. skip)?
        int32_t lmy = 0, lmx = 0;    // its MV (quarter-pel)
        int32_t lq1[2] = {0, 0};     // parts: left MB q1/q3 (mv, ref)
        int32_t lq3[2] = {0, 0};
        int lr1 = 0, lr3 = 0;
        for (uint64_t mbx = 0; mbx < mb_w; ++mbx) {
            uint64_t mb = i * mb_w + mbx;
            int m = mode[mb];
            const size_t nbx0 = mbx * 4 + 1, cnx0 = mbx * 2 + 1;
            if (m == 0) {
                ++skip_run;
                left_inter = true;   // P_Skip: mv == mvp_skip == (0,0)
                lmy = lmx = 0;
                lq1[0] = lq1[1] = lq3[0] = lq3[1] = 0;
                lr1 = lr3 = 0;
                for (int by = 0; by < 4; ++by)
                    for (int bx = 0; bx < 4; ++bx)
                        lnnz[by * lstr + nbx0 + bx] = 0;
                for (int by = 0; by < 2; ++by)
                    for (int bx = 0; bx < 2; ++bx) {
                        cbnnz[by * cstr + cnx0 + bx] = 0;
                        crnnz[by * cstr + cnx0 + bx] = 0;
                    }
                continue;
            }
            w.ue(skip_run);
            skip_run = 0;
            if (m == 2 || m == 3) {
                // 2 = Intra_16x16 DC, 3 = Intra_16x16 HORIZONTAL
                left_inter = false;
                cavlc::entropy_mb(w, mbx, mb_w, zdc + mb * 16,
                                  acz + mb * 256, czdc + mb * 8,
                                  cacz + mb * 128, lnnz, cbnnz, crnnz,
                                  /*type_offset=*/5,
                                  /*predmode=*/m == 3 ? 1 : 2);
            } else if (pmode) {
                const int pm = int(pmode[mb]);
                const int16_t* m4 = mv4 + mb * 8;
                const int16_t* r4 = ref4 ? ref4 + mb * 4 : nullptr;
                cavlc::entropy_p_mb_parts(
                    w, mbx, mb_w, acz + mb * 256, czdc + mb * 8,
                    cacz + mb * 128, lnnz, cbnnz, crnnz, pm, m4, r4,
                    active_refs, mbx > 0, left_inter, lq1, lq3, lr1,
                    lr3);
                left_inter = true;
                lq1[0] = m4[2];          // quadrant q1 (dy, dx)
                lq1[1] = m4[3];
                lq3[0] = m4[6];          // quadrant q3
                lq3[1] = m4[7];
                lr1 = r4 ? int(r4[1]) : 0;
                lr3 = r4 ? int(r4[3]) : 0;
            } else {
                const int32_t dy = mv ? mv[mb * 2] : 0;
                const int32_t dx = mv ? mv[mb * 2 + 1] : 0;
                const int32_t py = left_inter ? lmy : 0;
                const int32_t px = left_inter ? lmx : 0;
                cavlc::entropy_p_mb(w, mbx, mb_w, acz + mb * 256,
                                    czdc + mb * 8, cacz + mb * 128,
                                    lnnz, cbnnz, crnnz,
                                    dx - px, dy - py,
                                    ref ? int32_t(ref[mb]) : 0,
                                    active_refs);
                left_inter = true;
                lmy = dy;
                lmx = dx;
            }
        }
        if (skip_run) w.ue(skip_run);
        w.trailing();
        if (w.overflow) {
            failed.store(1, std::memory_order_relaxed);
            return;
        }
        EscState esc(out + i * stride);
        if (w.nbytes / 2 * 3 + w.nbytes % 2 + 1 > stride) {
            failed.store(1, std::memory_order_relaxed);
            return;
        }
        esc.feed(scratch + i * stride, w.nbytes);
        out_lens[i] = esc.o;
    };
    if (threads > 1 && mb_h > 1) {
        std::vector<std::thread> pool;
        std::atomic<uint64_t> next{0};
        unsigned n_workers = std::min<uint64_t>(mb_h, uint64_t(threads));
        for (unsigned t = 0; t < n_workers; ++t)
            pool.emplace_back([&] {
                std::vector<int8_t> ln(4 * lstr), cbn(2 * cstr),
                    crn(2 * cstr);
                for (uint64_t i = next.fetch_add(1); i < mb_h;
                     i = next.fetch_add(1))
                    one(i, ln.data(), cbn.data(), crn.data());
            });
        for (auto& t : pool) t.join();
    } else {
        std::vector<int8_t> ln(4 * lstr), cbn(2 * cstr), crn(2 * cstr);
        for (uint64_t i = 0; i < mb_h; ++i)
            one(i, ln.data(), cbn.data(), crn.data());
    }
    return failed.load() ? -1 : 0;
}

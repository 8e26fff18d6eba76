// framepipe_stress.cpp — sanitizer stress harness for the native runtime.
//
// The reference had no race detection (SURVEY §5); this harness runs the
// ring + resequencer under heavy multi-producer/consumer contention and is
// built with -fsanitize=thread by native/build_stress.sh, making the
// native transport's thread-safety machine-checked rather than asserted.
//
// Exit code 0 = all invariants held (TSAN reports races on stderr and
// returns non-zero via halt_on_error).

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <set>
#include <thread>
#include <vector>

#include "framepipe.cpp"  // single-TU build: the library is header-free

static constexpr size_t FRAME = 4096;
static constexpr int PRODUCERS = 4;
static constexpr int PER_PRODUCER = 2000;

int main() {
    FpRing* ring = fp_ring_new(32, FRAME);
    FpReseq* rs = fp_reseq_new(16, FRAME);
    std::atomic<bool> done{false};
    std::atomic<uint64_t> consumed{0};

    auto producer = [&](int pid) {
        std::vector<uint8_t> frame(FRAME);
        for (int i = 0; i < PER_PRODUCER; ++i) {
            std::memset(frame.data(), (pid * 37 + i) & 0xff, FRAME);
            fp_ring_push(ring, frame.data(), (uint64_t)pid * 1000000 + i);
        }
    };

    std::thread consumer([&] {
        std::vector<uint8_t> batch(8 * FRAME);
        std::vector<uint64_t> seqs(8);
        std::vector<uint8_t> out(FRAME);
        std::set<uint64_t> seen;
        uint64_t emit_seq = 0;
        while (true) {
            int64_t n = fp_ring_pop_batch(ring, batch.data(), seqs.data(), 8,
                                          10);
            if (n < 0) break;
            if (n == 0) {
                if (done.load()) {
                    // drain whatever remains then exit via closed ring
                    fp_ring_close(ring);
                }
                continue;
            }
            for (int64_t i = 0; i < n; ++i) {
                if (!seen.insert(seqs[i]).second) {
                    std::fprintf(stderr, "DUPLICATE seq %llu\n",
                                 (unsigned long long)seqs[i]);
                    std::exit(2);
                }
                // exercise the resequencer with a dense remapped sequence
                fp_reseq_push(rs, emit_seq++, batch.data() + i * FRAME);
                while (fp_reseq_emit(rs, out.data()) >= 0) {
                }
                consumed.fetch_add(1);
            }
        }
    });

    std::vector<std::thread> producers;
    for (int p = 0; p < PRODUCERS; ++p) producers.emplace_back(producer, p);
    for (auto& t : producers) t.join();
    done.store(true);
    consumer.join();

    uint64_t total = (uint64_t)PRODUCERS * PER_PRODUCER;
    uint64_t dropped = fp_ring_dropped(ring);
    if (consumed.load() + dropped != total) {
        std::fprintf(stderr, "ACCOUNTING: consumed %llu + dropped %llu != %llu\n",
                     (unsigned long long)consumed.load(),
                     (unsigned long long)dropped, (unsigned long long)total);
        return 3;
    }
    std::printf("stress OK: %llu consumed, %llu dropped (leaky), 0 dupes\n",
                (unsigned long long)consumed.load(),
                (unsigned long long)dropped);
    fp_reseq_free(rs);
    fp_ring_free(ring);

    // ---- phase 2: priority-aware push (QoS serving path) under the same
    // contention.  Producer pid has QoS class pid % 2; class_of(seq)
    // recovers it from the seq encoding.  Invariants: conservation
    // (consumed + evicted + rejected == pushed), every eviction is
    // attributed to a real not-yet-consumed seq, and a premium (class 1)
    // frame is never rejected outright (rc 2 needs every queued entry to
    // outrank it, impossible with only classes {0,1}).
    FpRing* pring = fp_ring_new(16, FRAME);
    std::atomic<uint64_t> pr_consumed{0};
    std::atomic<uint64_t> evicted[2] = {{0}, {0}};
    std::atomic<uint64_t> rejected[2] = {{0}, {0}};
    std::atomic<bool> pr_done{false};
    auto class_of = [](uint64_t seq) { return int((seq / 1000000) % 2); };

    auto pr_producer = [&](int pid) {
        std::vector<uint8_t> frame(FRAME);
        int32_t prio = pid % 2;
        for (int i = 0; i < PER_PRODUCER; ++i) {
            std::memset(frame.data(), (pid * 41 + i) & 0xff, FRAME);
            uint64_t seq = (uint64_t)pid * 1000000 + i;
            uint64_t ev = 0;
            int rc = fp_ring_push_prio(pring, frame.data(), seq, prio, &ev);
            if (rc == 1) evicted[class_of(ev)].fetch_add(1);
            else if (rc == 2) rejected[prio].fetch_add(1);
        }
    };

    std::thread pr_consumer([&] {
        std::vector<uint8_t> batch(8 * FRAME);
        std::vector<uint64_t> seqs(8);
        std::set<uint64_t> seen;
        while (true) {
            int64_t n = fp_ring_pop_batch(pring, batch.data(), seqs.data(), 8,
                                          10);
            if (n < 0) break;
            if (n == 0) {
                if (pr_done.load()) fp_ring_close(pring);
                continue;
            }
            for (int64_t i = 0; i < n; ++i) {
                if (!seen.insert(seqs[i]).second) {
                    std::fprintf(stderr, "PRIO DUPLICATE seq %llu\n",
                                 (unsigned long long)seqs[i]);
                    std::exit(4);
                }
                pr_consumed.fetch_add(1);
            }
        }
    });

    std::vector<std::thread> pr_producers;
    for (int p = 0; p < PRODUCERS; ++p) pr_producers.emplace_back(pr_producer, p);
    for (auto& t : pr_producers) t.join();
    pr_done.store(true);
    pr_consumer.join();

    uint64_t ev_total = evicted[0].load() + evicted[1].load();
    uint64_t rj_total = rejected[0].load() + rejected[1].load();
    if (pr_consumed.load() + ev_total + rj_total != total) {
        std::fprintf(stderr,
                     "PRIO ACCOUNTING: %llu consumed + %llu evicted + %llu "
                     "rejected != %llu\n",
                     (unsigned long long)pr_consumed.load(),
                     (unsigned long long)ev_total,
                     (unsigned long long)rj_total, (unsigned long long)total);
        return 5;
    }
    if (fp_ring_dropped(pring) != ev_total + rj_total) {
        std::fprintf(stderr, "PRIO DROP COUNTER mismatch\n");
        return 6;
    }
    if (rejected[1].load() != 0) {
        std::fprintf(stderr, "PRIO: premium frame rejected outright\n");
        return 7;
    }
    std::printf("prio stress OK: %llu consumed, evicted be=%llu prem=%llu, "
                "rejected be=%llu\n",
                (unsigned long long)pr_consumed.load(),
                (unsigned long long)evicted[0].load(),
                (unsigned long long)evicted[1].load(),
                (unsigned long long)rejected[0].load());
    fp_ring_free(pring);

    // ---- phase 3: capacity-2 ring with 4 producers — hammers the
    // all-slots-in-flight transient where the queue is empty while
    // free_slots is too (the eviction branch must reject, not read
    // queue.front() on an empty deque; ASAN catches the old UB).
    FpRing* tiny = fp_ring_new(2, FRAME);
    std::atomic<uint64_t> t_consumed{0};
    std::atomic<uint64_t> t_dropped_rc{0};
    std::atomic<bool> t_done{false};
    auto t_producer = [&](int pid) {
        std::vector<uint8_t> frame(FRAME, uint8_t(pid));
        for (int i = 0; i < PER_PRODUCER; ++i) {
            uint64_t ev = 0;
            int rc = fp_ring_push_prio(tiny, frame.data(),
                                       (uint64_t)pid * 1000000 + i,
                                       pid % 2, &ev);
            if (rc == 1 || rc == 2) t_dropped_rc.fetch_add(1);
        }
    };
    std::thread t_consumer([&] {
        std::vector<uint8_t> batch(2 * FRAME);
        std::vector<uint64_t> seqs(2);
        while (true) {
            int64_t got = fp_ring_pop_batch(tiny, batch.data(), seqs.data(),
                                            2, 5);
            if (got < 0) break;
            if (got == 0) {
                if (t_done.load()) fp_ring_close(tiny);
                continue;
            }
            t_consumed.fetch_add(uint64_t(got));
        }
    });
    std::vector<std::thread> t_producers;
    for (int p = 0; p < PRODUCERS; ++p) t_producers.emplace_back(t_producer, p);
    for (auto& t : t_producers) t.join();
    t_done.store(true);
    t_consumer.join();
    if (t_consumed.load() + fp_ring_dropped(tiny) != total) {
        std::fprintf(stderr, "TINY ACCOUNTING: %llu + %llu != %llu\n",
                     (unsigned long long)t_consumed.load(),
                     (unsigned long long)fp_ring_dropped(tiny),
                     (unsigned long long)total);
        return 8;
    }
    if (fp_ring_dropped(tiny) != t_dropped_rc.load()) {
        std::fprintf(stderr, "TINY DROP RC mismatch\n");
        return 9;
    }
    std::printf("tiny-ring stress OK: %llu consumed, %llu dropped\n",
                (unsigned long long)t_consumed.load(),
                (unsigned long long)fp_ring_dropped(tiny));
    fp_ring_free(tiny);

    // ---- phase 4: threaded I_PCM access-unit assembly — parallel slice
    // bands write disjoint strided regions of one arena, then compact.
    // TSAN checks the band workers really are disjoint; ASAN bounds the
    // arena math (escape worst case); output must equal the sequential
    // encode bit-for-bit, on zero-heavy content (max escape insertions).
    {
        const uint64_t W = 96, H = 64, S = 4;
        const uint64_t mb_h = (H + 15) / 16, mb_w = (W + 15) / 16;
        std::vector<uint8_t> nv12(W * H * 3 / 2);
        for (size_t i = 0; i < nv12.size(); ++i)
            nv12[i] = uint8_t((i * 7) % 5);  // lots of 0..3: escape-heavy
        // fake but realistic heads: nonzero syntax bytes + prefix slot
        std::vector<uint8_t> heads_blob;
        std::vector<uint64_t> head_lens, bounds;
        for (uint64_t i = 0; i <= S; ++i)
            bounds.push_back(i * mb_h / S);
        for (uint64_t i = 0; i < S; ++i) {
            for (int k = 0; k < 6; ++k)
                heads_blob.push_back(uint8_t(0x65 + i));
            head_lens.push_back(6);
        }
        const uint8_t prelude[9] = {0, 0, 0, 1, 0x67, 0x42, 0, 0, 1};
        uint64_t cap = 9;
        for (uint64_t i = 0; i < S; ++i)
            cap += 4 + (head_lens[i] - 2 +
                        (bounds[i + 1] - bounds[i]) * mb_w * 386 + 1 + 1) /
                           2 * 3;
        std::vector<uint8_t> seq_out(cap), par_out(cap);
        int64_t n_seq = fp_pcm_encode_au(nv12.data(), W, H, prelude, 9,
                                         heads_blob.data(), head_lens.data(),
                                         bounds.data(), S, 1, seq_out.data(),
                                         cap);
        int64_t n_par = fp_pcm_encode_au(nv12.data(), W, H, prelude, 9,
                                         heads_blob.data(), head_lens.data(),
                                         bounds.data(), S, 4, par_out.data(),
                                         cap);
        if (n_seq <= 0 || n_par != n_seq ||
            std::memcmp(seq_out.data(), par_out.data(), size_t(n_seq)) != 0) {
            std::fprintf(stderr, "PCM threaded/sequential mismatch: %lld vs %lld\n",
                         (long long)n_seq, (long long)n_par);
            return 10;
        }
        std::printf("pcm-au stress OK: %lld bytes, threaded == sequential\n",
                    (long long)n_seq);
    }

    // ---- phase 5: threaded CAVLC slice bands — parallel workers share
    // the reconstruction/nnz planes but touch only their own MB rows
    // (contexts reset at band tops).  TSAN checks the claimed
    // disjointness; output must equal the sequential encode exactly.
    {
        const uint64_t W = 96, H = 96, S = 3;
        const uint64_t mb_h = H / 16, mb_w = W / 16;
        std::vector<uint8_t> nv12(W * H * 3 / 2);
        for (size_t i = 0; i < nv12.size(); ++i)
            nv12[i] = uint8_t((i * 131 + (i >> 5) * 7) & 0xff);
        // minimal plausible slice heads: a few syntax-looking bits each
        std::vector<uint8_t> heads_blob;
        std::vector<uint64_t> head_nbits, bounds;
        for (uint64_t i = 0; i <= S; ++i)
            bounds.push_back(i * mb_h / S);
        for (uint64_t i = 0; i < S; ++i) {
            heads_blob.push_back(0x65);
            heads_blob.push_back(uint8_t(0x88 + i));
            heads_blob.push_back(0x84);
            head_nbits.push_back(22);  // deliberately not byte-aligned
        }
        const uint64_t stride = 2200 * mb_h * mb_w * 3 / 2 + 256;
        std::vector<uint8_t> scr(S * stride), seq_o(S * stride),
            par_o(S * stride);
        std::vector<uint64_t> seq_l(S), par_l(S);
        int64_t r1 = fp_cavlc_encode_slices(
            nv12.data(), W, H, 6, heads_blob.data(), head_nbits.data(),
            bounds.data(), S, 1, scr.data(), stride, seq_o.data(),
            seq_l.data());
        int64_t r2 = fp_cavlc_encode_slices(
            nv12.data(), W, H, 6, heads_blob.data(), head_nbits.data(),
            bounds.data(), S, 4, scr.data(), stride, par_o.data(),
            par_l.data());
        bool ok = r1 == 0 && r2 == 0;
        uint64_t total = 0;
        for (uint64_t i = 0; ok && i < S; ++i) {
            ok = seq_l[i] == par_l[i] &&
                 std::memcmp(seq_o.data() + i * stride,
                             par_o.data() + i * stride,
                             size_t(seq_l[i])) == 0;
            total += seq_l[i];
        }
        if (!ok) {
            std::fprintf(stderr, "CAVLC threaded/sequential mismatch\n");
            return 11;
        }
        std::printf("cavlc stress OK: %llu bytes over %llu slices, "
                    "threaded == sequential\n",
                    (unsigned long long)total, (unsigned long long)S);
    }

    // ---- phase 6: threaded P-frame entropy rows (skip/inter/intra mix)
    // — one worker per MB row, rows fully independent; threaded output
    // must equal sequential byte-for-byte.
    {
        const uint64_t mb_h = 8, mb_w = 6, n = mb_h * mb_w;
        std::vector<int16_t> mode(n), zdc(n * 16, 0), acz(n * 256, 0),
            czdc(n * 8, 0), cacz(n * 128, 0);
        for (uint64_t mb = 0; mb < n; ++mb) {
            int m = int(mb % 3);  // cycle skip / inter / intra
            mode[mb] = int16_t(m);
            if (m == 1) {  // inter: full 4x4 blocks incl. DC
                for (int i = 0; i < 256; i += 7)
                    acz[mb * 256 + i] = int16_t((i % 5) - 2);
                czdc[mb * 8 + 1] = 3;
                cacz[mb * 128 + 18] = -1;
            } else if (m == 2) {  // intra: zdc + AC (DC slots zero)
                for (int b = 0; b < 16; ++b)
                    acz[mb * 256 + b * 16 + 1 + (b % 9)] =
                        int16_t((b % 3) - 1);
                zdc[mb * 16 + 2] = -4;
                czdc[mb * 8 + 5] = 1;
            }
        }
        std::vector<uint8_t> heads_blob;
        std::vector<uint64_t> head_nbits;
        for (uint64_t i = 0; i < mb_h; ++i) {
            heads_blob.push_back(0x41);
            heads_blob.push_back(uint8_t(0x9a + i));
            heads_blob.push_back(0x20);
            head_nbits.push_back(21);
        }
        // per-MB MVs: non-zero on inter MBs, exercising the left-MV
        // predictor chain and mvd coding under threading
        std::vector<int16_t> mv(n * 2, 0);
        for (uint64_t mb = 0; mb < n; ++mb)
            if (mb % 3 == 1) {
                mv[mb * 2] = int16_t(2 * int(mb % 5) - 4);
                mv[mb * 2 + 1] = int16_t(4 - 2 * int(mb % 4));
            }
        const uint64_t stride = (2200 * mb_w + 96) / 2 * 3 + 64;
        std::vector<uint8_t> scr(mb_h * stride), seq_o(mb_h * stride),
            par_o(mb_h * stride);
        std::vector<uint64_t> seq_l(mb_h), par_l(mb_h);
        // ref field: every third inter MB uses reference 1
        std::vector<int16_t> reff(n, 0);
        for (uint64_t mb = 0; mb < n; ++mb)
            if (mb % 3 == 1 && mb % 2 == 0) reff[mb] = 1;
        int64_t r1 = fp_cavlc_entropy_rows_p(
            mode.data(), zdc.data(), acz.data(), czdc.data(),
            cacz.data(), mv.data(), reff.data(), 2, mb_h, mb_w,
            heads_blob.data(), head_nbits.data(), 1, scr.data(),
            stride, seq_o.data(), seq_l.data(), nullptr, nullptr,
            nullptr);
        int64_t r2 = fp_cavlc_entropy_rows_p(
            mode.data(), zdc.data(), acz.data(), czdc.data(),
            cacz.data(), mv.data(), reff.data(), 2, mb_h, mb_w,
            heads_blob.data(), head_nbits.data(), 4, scr.data(),
            stride, par_o.data(), par_l.data(), nullptr, nullptr,
            nullptr);
        // null mv = zero motion must also hold under threading
        std::vector<uint8_t> z_o(mb_h * stride), z2_o(mb_h * stride);
        std::vector<uint64_t> z_l(mb_h), z2_l(mb_h);
        int64_t r3 = fp_cavlc_entropy_rows_p(
            mode.data(), zdc.data(), acz.data(), czdc.data(),
            cacz.data(), nullptr, nullptr, 1, mb_h, mb_w,
            heads_blob.data(), head_nbits.data(), 1, scr.data(),
            stride, z_o.data(), z_l.data(), nullptr, nullptr,
            nullptr);
        int64_t r4 = fp_cavlc_entropy_rows_p(
            mode.data(), zdc.data(), acz.data(), czdc.data(),
            cacz.data(), nullptr, nullptr, 1, mb_h, mb_w,
            heads_blob.data(), head_nbits.data(), 3, scr.data(),
            stride, z2_o.data(), z2_l.data(), nullptr, nullptr,
            nullptr);
        bool ok = r1 == 0 && r2 == 0 && r3 == 0 && r4 == 0;
        for (uint64_t i = 0; ok && i < mb_h; ++i)
            ok = z_l[i] == z2_l[i] &&
                 std::memcmp(z_o.data() + i * stride,
                             z2_o.data() + i * stride,
                             size_t(z_l[i])) == 0;
        uint64_t total = 0;
        for (uint64_t i = 0; ok && i < mb_h; ++i) {
            ok = seq_l[i] == par_l[i] &&
                 std::memcmp(seq_o.data() + i * stride,
                             par_o.data() + i * stride,
                             size_t(seq_l[i])) == 0;
            total += seq_l[i];
        }
        if (!ok) {
            std::fprintf(stderr,
                         "P entropy threaded/sequential mismatch\n");
            return 12;
        }
        std::printf("p-entropy stress OK: %llu bytes over %llu rows, "
                    "threaded == sequential\n",
                    (unsigned long long)total,
                    (unsigned long long)mb_h);
    }
    return 0;
}

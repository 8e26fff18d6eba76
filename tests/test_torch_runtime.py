"""The port's copies of the runtime and metrics modules against the JAX package's.

The port imports nothing of the JAX package, so it carries its own copies
of ``runtime/feeder.py``, ``queues.py``, ``sequencer.py`` and
``metrics/counters.py``, ``timing.py``.  The same scenario through both
must give the same outputs, order and stats.  ``native_staging`` takes the
frame shape of the C++ ring's slots and raises on anything else; the ring
itself is tested in ``tests/test_torch_native.py``.
"""

import threading
import time

import numpy as np
import pytest

from opencv_opencl_tpu.metrics import counters as jax_counters
from opencv_opencl_tpu.metrics import timing as jax_timing
from opencv_opencl_tpu.runtime import feeder as jax_feeder
from opencv_opencl_tpu.runtime import queues as jax_queues
from opencv_opencl_tpu.runtime import sequencer as jax_sequencer
from opencv_opencl_tpu_torch.metrics import counters, timing
from opencv_opencl_tpu_torch.runtime import feeder, queues, sequencer

PAIRS = [(jax_feeder, jax_queues, jax_sequencer), (feeder, queues, sequencer)]


def _step(batch):
    """A deterministic batch step: each pixel plus its row index."""
    return (batch.astype(np.int32) + np.arange(batch.shape[1])[None, :, None]
            ).astype(np.uint8)


def _feeder_run(mod, frames, **kw):
    outs, drops, lock = [], [], threading.Lock()

    def on_output(seq, frame, meta):
        with lock:
            outs.append((seq, meta, frame.copy()))

    f = mod.FrameFeeder(_step, batch_size=3, depth=2, on_output=on_output,
                        on_drop_item=lambda item: drops.append(item[0]), **kw)
    # queue everything first: the drops and the batches are then the same
    # in every run
    for i, frame in enumerate(frames):
        f.submit(frame, meta=("m", i))
    f.start()
    f.stop(drain=True, timeout=60)
    return outs, drops, f.stats


@pytest.mark.parametrize("priority", [False, True], ids=["leaky", "priority"])
def test_feeder_scenario_equals_jax(priority):
    frames = [np.full((6, 5), i, np.uint8) for i in range(11)]
    kw = dict(queue_capacity=7)
    if priority:
        kw["priority_of"] = lambda item: item[0] % 3
    got = _feeder_run(feeder, frames, **kw)
    want = _feeder_run(jax_feeder, frames, **kw)
    assert [(s, m) for s, m, _ in got[0]] == [(s, m) for s, m, _ in want[0]]
    for (_, _, a), (_, _, b) in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    assert got[1] == want[1] and got[1]          # the same frames dropped
    assert got[2] == want[2]
    assert [s for s, _, _ in got[0]] == list(range(len(got[0])))


def test_feeder_warmup_and_idle_retire_equal_jax():
    results = []
    for mod in (jax_feeder, feeder):
        outs = []
        f = mod.FrameFeeder(_step, batch_size=4, depth=3,
                            on_output=lambda s, fr, m: outs.append((s, int(fr.sum()))))
        f.warmup((4, 4))
        f.start()
        for i in range(5):
            f.submit(np.full((4, 4), i, np.uint8))
        f.stop(drain=True, timeout=60)
        results.append((outs, f.stats, f.queue_length()))
    assert results[0] == results[1]


@pytest.mark.parametrize("staging", [True, (6, 0)])
def test_native_staging_raises(staging):
    with pytest.raises(ValueError, match="native_staging takes the frame shape"):
        feeder.FrameFeeder(_step, native_staging=staging)


@pytest.mark.parametrize("prio", [False, True])
def test_queues_equal_jax(prio):
    logs = []
    for _, q_mod, _ in PAIRS:
        dropped = []
        kw = dict(max_size=3, on_drop=dropped.append)
        q = (q_mod.PriorityLeakyQueue(priority_of=lambda x: x % 2, **kw)
             if prio else q_mod.LeakyQueue(**kw))
        puts = [q.put(i) for i in range(7)]
        first = q.get_batch(2, timeout=0.1)
        rest = [q.get(timeout=0.1)]
        q.put(9)
        n_clear = q.clear()
        q.close()
        with pytest.raises(q_mod.Closed):
            q.get(timeout=0.1)
        logs.append((puts, dropped, first, rest, n_clear, q.dropped, len(q)))
    assert logs[0] == logs[1]


def test_resequencer_equals_jax():
    logs = []
    for _, _, s_mod in PAIRS:
        emitted = []
        r = s_mod.Resequencer(lambda s, f: emitted.append((s, f)), max_pending=3)
        for seq in (1, 0, 3, 5, 6, 7, 8, 2, 10):
            r.push(seq, f"f{seq}")
        r.flush()
        logs.append((emitted, r.dropped_late, r.frames_lost, r.emitted, r.next_seq))
    assert logs[0] == logs[1]


def test_metrics_equal_jax():
    reports = []
    for c_mod, t_mod in ((jax_counters, jax_timing), (counters, timing)):
        c = c_mod.FrameRateCounters()
        for stage, n in (("input_frames", 5), ("output_frames", 4),
                         ("dropped_overflow", 1)):
            c.count(stage, n)
        printed = []
        t = t_mod.TimingStats(window=4, label="x", printer=printed.append)
        for i in range(6):
            t.record(1.0 + i, 0.5 * i, 2.0 + 1.5 * i)
        status = c_mod.classify_status(accel_errors=0, processing_errors=0,
                                       queue_length=6, output_fps=3.0)
        reports.append((c.snapshot(), c.get("input_frames"), status,
                        t.avg_total_ms, t.percentile_total_ms(95),
                        t.window_report(), t.final_report(), printed))
    assert reports[0] == reports[1]


def test_feeder_drains_a_frame_queued_as_its_pop_times_out():
    """stop(drain=True) right after the last submit emits that frame even
    when the feeder's idle pop timed out just before the frame was queued
    and stop() began (the pop is made to time out then, once)."""
    outs = []
    f = feeder.FrameFeeder(_step, batch_size=2, depth=1,
                           on_output=lambda seq, frame, meta: outs.append(seq))
    real = f._inq.get_batch
    timed_out = threading.Event()

    def get_batch(max_items, timeout=None):
        if not timed_out.is_set():
            deadline = time.monotonic() + 10.0
            while not f._inq._closed and time.monotonic() < deadline:
                time.sleep(0.001)
            timed_out.set()
            raise TimeoutError("queue get timed out")
        return real(max_items, timeout)

    f._inq.get_batch = get_batch
    f.start()
    f.submit(np.zeros((4, 6), np.uint8))
    f.stop(drain=True, timeout=10.0)
    assert timed_out.is_set()
    assert outs == [0] and f.stats["emitted"] == 1
    assert f.stats.get("processing_errors", 0) == 0

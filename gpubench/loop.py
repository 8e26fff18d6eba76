"""The measured window: a closed loop that keeps ``in_flight`` steps
dispatched ahead and issues the next as soon as the oldest is complete.

Each step is timed on the host: its issue (the call into the port) and its
completion as the host observes it, after the next step has been issued.
A traced run has the profiler on for ``trace_seconds`` after the first
``seconds - trace_seconds`` of the window, between two points at which the
card is drained (the profiler's own start, which takes seconds, is not in
the traced part); its host numbers come from the steps before that.  The steps that the check may keep are
drawn from the seed by reservoir sampling, so that every checkable step of
the window is equally likely to be compared, and their outputs are held.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import time

import torch

from gpubench import trace as trace_mod


@dataclasses.dataclass
class Record:
    k: int
    issued_s: float       # from the window's start
    issue_s: float        # the call into the port
    done_s: float         # from the window's start, as the host saw it
    frames: int
    parts: dict
    kinds: dict
    traced: bool


@dataclasses.dataclass
class Window:
    records: list
    seconds: float          # from the first issue to the completion that closed it
    attempted: int          # frames of every step issued in the window
    kept: list
    trace: trace_mod.DeviceTrace | None


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def run(system, seconds: float, in_flight: int, sample: int, seed: int,
        trace_seconds: float = 0.0) -> Window:
    """Run ``system`` for ``seconds``; with ``trace_seconds`` the last part
    runs under the profiler, for that long after the profiler has started."""
    cuda = system.seq.device.type == "cuda"
    rng = random.Random(int(seed) ^ 0x5EED)
    records, kept, pending = [], [], collections.deque()
    seen = attempted = 0
    tracing = False
    prof = None
    trace_at = seconds - trace_seconds if trace_seconds else None
    t_start = time.perf_counter()
    t_end = t_start
    trace_t0 = 0.0

    def retire(entry, traced):
        nonlocal t_end
        k, t0, t1, step = entry
        with _span("gpubench.wait", traced):
            step.wait()
        t_end = time.perf_counter()
        records.append(Record(k, t0 - t_start, t1 - t0, t_end - t_start, step.frames,
                              step.parts, step.kinds, traced))

    k = 0
    while True:
        if trace_at is not None and not tracing and time.perf_counter() - t_start >= trace_at:
            while pending:
                retire(pending.popleft(), False)
            if cuda:
                torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            tracing = True
            trace_t0 = time.perf_counter()
        t0 = time.perf_counter()
        with _span(f"gpubench.{system.span}", tracing):
            step = system.issue(k)
        t1 = time.perf_counter()
        attempted += step.frames
        if system.checkable(k):
            seen += 1
            if len(kept) < sample:
                kept.append(step.kept())
            else:
                j = rng.randrange(seen)
                if j < sample:
                    kept[j] = step.kept()
        pending.append((k, t0, t1, step))
        k += 1
        if len(pending) >= in_flight:
            retire(pending.popleft(), tracing)
            if (t_end - trace_t0 >= trace_seconds if tracing
                    else t_end - t_start >= seconds):
                break
    window_end = t_end
    while pending:
        retire(pending.popleft(), tracing)
    if cuda:
        torch.cuda.synchronize()
    dev_trace = None
    if prof is not None:
        window_s = time.perf_counter() - trace_t0
        prof.__exit__(None, None, None)
        dev_trace = trace_mod.read(prof, window_s)
    return Window(records, window_end - t_start, attempted, kept, dev_trace)

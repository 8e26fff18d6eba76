"""The device's side of a traced window, read from ``torch.profiler``'s
trace: every kernel, copy and set on the card with its start and length,
the harness's own spans on the host (``record_function`` names that start
with ``gpubench.``), the seconds in which the card was busy, the device
operations that took most time and the longest idle gaps named by the span
the host was in when each began."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "gpubench."
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    ops: list            # (name, start_us, dur_us, cat), by start
    spans: list          # (name, start_us, end_us) of the harness's spans
    window_s: float      # the traced window's length on the host's clock

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card (their union)."""
        busy, end = 0.0, None
        for _, start, dur, _ in self.ops:
            stop = start + dur
            if end is None or start > end:
                busy += dur
                end = stop
            elif stop > end:
                busy += stop - end
                end = stop
        return busy * 1e-6

    def device_time(self, pattern: str, cats=("kernel",)) -> float:
        """Seconds of the operations whose short name matches ``pattern``."""
        rx = re.compile(pattern)
        return 1e-6 * sum(d for n, _, d, c in self.ops if c in cats and rx.search(n))

    def top_ops(self) -> list:
        totals: dict[str, float] = {}
        for n, _, d, _ in self.ops:
            totals[n] = totals.get(n, 0.0) + d * 1e-6
        return sorted(([n, s] for n, s in totals.items()), key=lambda e: -e[1])[:TOP]

    def idle_gaps(self) -> list:
        """The longest gaps between device operations, each named by the
        innermost harness span that held the host when the gap began."""
        gaps, end = [], None
        for _, start, dur, _ in self.ops:
            if end is not None and start > end:
                gaps.append((end, start))
            end = start + dur if end is None else max(end, start + dur)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:TOP]:
            inside = [s for s in self.spans if s[1] <= g0 < s[2]]
            name = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "outside the spans"
            out.append([name, (g1 - g0) * 1e-6])
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and argument
    list; one of PyTorch's own kernels as ``at::`` and the names of the
    functors inside it (``at::elementwise_kernel/direct_copy_kernel_cuda``)."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    if name.startswith("at::"):
        words = re.findall(r"at::native::([A-Za-z_]\w*)", name)
        return "at::" + "/".join(dict.fromkeys(words))
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def read(prof, window_s: float) -> DeviceTrace:
    """The trace of a stopped ``torch.profiler.profile``; its chrome trace
    goes through a temporary file under ``TMPDIR`` that is removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            name = e.get("name", "")
            ops.append((short_name(name) if cat == "kernel" else name.strip(),
                        float(e["ts"]), float(e["dur"]), cat))
        elif cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            spans.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    ops.sort(key=lambda o: o[1])
    return DeviceTrace(ops, spans, window_s)

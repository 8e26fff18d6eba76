"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``) runs from the start of this process to the first timed
step: torch and the card, the frame sequence made on the card from the
seed, the port's step and kernel library, and a warm-up of the window's
shapes.  The window runs the closed loop of ``loop.py``; with ``--trace 1``
its last seconds run under the profiler and the line carries the cell's
per-layer metrics instead of its end-to-end ones.  Once the window has
closed and the peak memory has been read, the kept steps are compared with
the plain reference; each compared number is printed beside its limit as
the last lines on standard error and under ``checks``, the line's last key.

The run fails (exit code other than 0, no result line) without a card, with
fewer cards than the cell asks for, without the port, or when JAX or the
JAX package has been loaded into this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gpubench")

FORBIDDEN = ("jax", "jaxlib", "flax", "opencv_opencl_tpu")
# the seconds of the window's end that a traced run traces
TRACE_SECONDS = 2.0
WARM_STEPS = 3
LIMIT = 0


def loaded_forbidden(modules=None) -> list[str]:
    """The top-level names in ``modules`` (``sys.modules``) that are JAX or
    the JAX package, compared whole: ``opencv_opencl_tpu_torch`` is the
    port and passes."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_of(manifest: dict, workload: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list it, and those without a list whose ``moves`` the cell
    reports."""
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]


def reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_name_power() -> str | None:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    res = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else None


class Context:
    """What a per-layer metric's reader may read."""

    def __init__(self, system, window):
        self.system = system
        self.trace = window.trace
        self.host = [r for r in window.records if not r.traced]
        traced = [r for r in window.records if r.traced]
        self.traced = {key: sum(r.kinds.get(key, 0) for r in traced)
                       for key in ("frames", "idr_frames", "p_frames")}
        self.traced["steps"] = len(traced)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(workload: str, seed: int, device=None, manifest=None, overrides=None):
    """(manifest, cell, traffic, system) with the system built on
    ``device`` (None: the card, which must be there).  ``overrides`` (tests
    only) updates the configuration's and the traffic's keys: ``{"config":
    {...}, "traffic": {...}}``."""
    import torch

    from gpubench import frames

    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    cell = cell_of(manifest, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{workload} needs {cell['chips']} CUDA card(s); "
                             f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
    overrides = overrides or {}
    config = {**load_json(HERE, "configs", f"{cell['config']}.json"),
              **overrides.get("config", {})}
    traffic = frames.Traffic.from_json({
        **load_json(HERE, "traffic", f"{cell['traffic']}.json"),
        **overrides.get("traffic", {})})
    system = importlib.import_module(f"gpubench.systems.{config['system']}").System(
        config, traffic, seed, device)
    return manifest, cell, traffic, system


def measure(workload: str, seed: int, seconds: float, trace: bool, device=None,
            manifest=None, overrides=None, t0: float = T0) -> dict:
    """One run of the cell; the result line's object."""
    import torch

    from gpubench import loop

    manifest, cell, traffic, system = prepare(workload, seed, device, manifest, overrides)
    cuda = system.seq.device.type == "cuda"
    system.warm_up(WARM_STEPS, traffic.in_flight + system.check_steps + 1)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    window = loop.run(system, seconds, traffic.in_flight, system.check_steps, seed,
                      TRACE_SECONDS if trace else 0.0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics = {}
    wanted = metrics_of(manifest, workload, trace)
    if trace:
        ctx = Context(system, window)
        for m in wanted:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        done = sum(r.frames for r in window.records if r.done_s <= window.seconds)
        # a frame is done when the step's output is complete: on the card
        # (frames_per_s) or, for the encoding cells, as lanes on the host
        values = {"setup_s": setup_s, "frames_per_s": done / window.seconds,
                  "encoded_frames_per_s": done / window.seconds}
        for m in wanted:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    failed = window.attempted - sum(r.frames for r in window.records)

    kept = window.kept
    checks = system.compare(kept)
    correct = failed == 0 and all(v <= LIMIT for v in checks.values()) and bool(kept)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"] if cuda else 0,
                   "memory_peak_bytes": int(peak),
                   "name_power_limit": card_name_power() if cuda else None}
    result = {"correct": correct, "attempted": window.attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and window.trace is not None:
        device_info["busy_s"] = window.trace.busy_s
        device_info["window_s"] = window.trace.window_s
        result["breakdown"] = {"device_ops": window.trace.top_ops(),
                               "idle_gaps": window.trace.idle_gaps()}
    result["checks"] = {"steps_compared": {"value": len(kept), "limit": "at least 1"},
                        **{name: {"value": v, "limit": LIMIT} for name, v in checks.items()}}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import opencv_opencl_tpu_torch  # the port: the system under test
    except ImportError as exc:
        print(f"the port is not importable here: {exc}", file=sys.stderr)
        return 2
    if not os.path.abspath(opencv_opencl_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"the port must come from this checkout, not "
              f"{opencv_opencl_tpu_torch.__file__}", file=sys.stderr)
        return 2
    # the host's share of the work is one Python thread issuing launches:
    # no pool of CPU threads beside it
    import torch

    torch.set_num_threads(1)
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"refused: this process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

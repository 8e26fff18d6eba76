"""A whole run of each cell on the CPU at a small size (the port's plain
versions under the timed path): the shape of the result line, and
``correct`` coming out false under each fault the cell can have and under
the control.  The card's smoke is marked ``cuda``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import control, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 21
GOP = {"qp": 30, "gop": 6, "search": 8, "subpel": 3, "refs": 1, "deblock": True}


def small(workload):
    config = {"width": 96, "height": 64, "check_steps": 2}
    traffic = {"pool_frames": 6}
    if workload.startswith("clahe_h264_4k"):
        config["encoder"] = GOP
    if workload == "clahe_4k.streams32":
        traffic["streams"] = 4
    elif workload == "clahe_h264_4k.pan":
        traffic["noise_block"] = [16, 16]
    else:
        traffic["object"] = {"size": [16, 16], "step": [0, 8]}
    return {"config": config, "traffic": traffic}


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", cells())
def test_the_result_line(workload, trace):
    seconds = 2.5 if workload.startswith("clahe_h264") else 0.5
    r = run.measure(workload, SEED, seconds, bool(trace), device="cpu",
                    overrides=small(workload))
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == bool(trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    manifest = run.load_json(ROOT, "BENCHMARK.json")
    allowed = {m["name"] for m in run.metrics_of(manifest, workload, bool(trace))}
    assert set(r["metrics"]) <= allowed
    if not trace:
        assert set(r["metrics"]) == allowed
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def _faulty(monkeypatch, workload, fault):
    """Break the timed path underneath: wrap the step the system builds."""
    from gpubench.systems import enhance, fused_gop

    if workload == "clahe_4k.streams32":
        real = enhance.System.__init__

        def init(self, *a, **k):
            real(self, *a, **k)
            fn = self.fn

            def broken(x):
                out = fn(x)
                if fault == "half_batch":
                    out[out.shape[0] // 2:] = x[out.shape[0] // 2:]
                elif fault == "altered":
                    out[-1, 3, 5] ^= 1
                elif fault == "chroma_dropped":
                    out[:, out.shape[1] * 2 // 3:] = 0
                return out

            self.fn = broken

        monkeypatch.setattr(enhance.System, "__init__", init)
        return
    real = fused_gop.System.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        fn, gop, handed = self.fn, self.gop, []

        def broken(x, qp, idx0, *recon):
            # a step that does not start a GOP predicts from zero pictures,
            # or from the picture handed on two steps before
            if fault == "carry_ignored" and idx0 % gop:
                recon = tuple(torch.zeros_like(t) for t in recon)
            elif fault == "carry_stale" and idx0 % gop and len(handed) == 2:
                recon = handed[0]
            packed, *rec = fn(x, qp, idx0, *recon)
            handed[:] = (handed + [tuple(rec)])[-2:]
            if fault == "state_unchanged":
                rec = recon
            elif fault == "half_batch":
                half = packed.shape[0] // 2
                packed = torch.cat([packed[:half], packed[:packed.shape[0] - half]])
            elif fault == "altered":
                packed = packed.clone()
                packed[-1, 0, 0, 20] += 1
            return (packed, *rec)

        self.fn = broken

    monkeypatch.setattr(fused_gop.System, "__init__", init)


@pytest.mark.parametrize("workload,fault", [
    ("clahe_4k.streams32", "half_batch"), ("clahe_4k.streams32", "altered"),
    ("clahe_4k.streams32", "chroma_dropped"),
    ("clahe_h264_4k.pan", "state_unchanged"), ("clahe_h264_4k.pan", "half_batch"),
    ("clahe_h264_4k.pan", "altered"), ("clahe_h264_4k.static", "state_unchanged"),
    ("clahe_h264_4k.pan", "carry_ignored"), ("clahe_h264_4k.pan", "carry_stale"),
    ("clahe_h264_4k.static", "carry_ignored"),
])
def test_a_broken_step_is_not_correct(monkeypatch, workload, fault):
    _faulty(monkeypatch, workload, fault)
    seconds = 2.5 if workload.startswith("clahe_h264") else 0.5
    r = run.measure(workload, SEED + 1, seconds, False, device="cpu",
                    overrides=small(workload))
    assert r["correct"] is False
    assert any(c["value"] for name, c in r["checks"].items() if name != "steps_compared")


@pytest.mark.parametrize("workload", ["clahe_4k.streams32", "clahe_h264_4k.pan"])
def test_the_control_fails_where_the_program_passes(workload):
    out = control.readings(workload, SEED + 2, 2.5 if "h264" in workload else 0.5,
                           True, device="cpu", overrides=small(workload))
    assert out["steps_compared"] >= 1
    assert not any(out["program"].values())
    assert any(out["control"].values())


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short traced run of the CLAHE cell on a card, through the
    command line; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                          "clahe_4k.streams32", "--seed", str(SEED), "--seconds", "3",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0

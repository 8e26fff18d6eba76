"""``BENCHMARK.json`` against the benchmark's contract: keys, names, units,
limits, the files each entry names, and which cell reports which metric."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_are_unique_and_well_formed(manifest):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys(manifest, group, keys):
    for e in manifest[group]:
        assert set(e) - {"workloads"} == keys, e["name"]


def test_configs_files_and_reductions(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in manifest["paths"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert os.path.basename(c["file"]) == c["name"] + ".json"


def test_workloads(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "gpubench", "traffic", w["traffic"] + ".json"))
    assert 1 <= len(manifest["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_metrics_and_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "gpubench", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    e2e_of = {c: {m["name"] for m in manifest["end_to_end"]
                  if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in e2e_of[c] and len(e2e_of[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in e2e_of[c], (m["name"], c)
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_run_seconds_fits_a_full_check(manifest):
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

"""The port's sharded encoder (``parallel/sharded_encode.py``) on gloo groups
on the CPU, against the JAX package's and against the port's single-card
encoders.

All the port's cases run in one group of four processes
(``launch.run_on_mesh((2, 2), launch.compare_with_encoder, ...)`` with
``device_type="cpu"``: one spawn, since a spawn imports torch), the
single-card references in the test's process meanwhile.  The JAX package's builders
run on its 8-device CPU mesh cut to ``make_mesh(shape=(2, 2))``, each
configuration compiled once (module-scoped fixtures):

- GOP-per-rank: ``build_mesh_gop_fn`` (``gop=3:search=2``, 19 frames: two
  GOPs a rank and a ragged tail) and ``build_mesh_levels_fn`` (10 frames)
  give the JAX builders' packed lanes element for element.  JAX's CPU CLAHE
  flips rare exact-tie pixels by one (``tests/conftest.py``'s
  ``assert_clahe_close``), so the JAX step is given the port's enhanced
  frames with ``op="none"``;
- the access units are byte-identical to the single-card
  ``CudaGopEncoder`` / ``CudaCavlcEncoder`` (``device="cpu"``) fed the
  single-card enhanced frames, for every encoder option of
  ``tests/test_sharded_encode.py``;
- ``BandedCudaGopEncoder`` over four bands of 64x128 (two MB rows each)
  gives ``BandedTpuGopEncoder``'s access units (``search=4``) and the
  single-card ``CudaGopEncoder``'s for the seven options of
  ``test_banded_byte_identical``; its refusals are the JAX class's.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core.frames import ChromaPolicy as JaxChroma
from opencv_opencl_tpu.core.frames import FrameSpec as JaxSpec
from opencv_opencl_tpu.io.h264_cavlc import TpuCavlcEncoder
from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
from opencv_opencl_tpu.models.enhancer import EnhancerConfig as JaxConfig
from opencv_opencl_tpu.parallel import sharded_encode as jax_sharded
from opencv_opencl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.io.h264_cavlc import CudaCavlcEncoder
from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder
from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig, build_enhance_fn
from opencv_opencl_tpu_torch.parallel import launch, sharded_encode

W, H, QP = 64, 48, 30
BW, BH, BN = 64, 128, 4          # banded: mb_h 8 over 4 ranks; an IDR, 3 P
RANKS = 4


def _frames(n: int, w: int = W, h: int = H) -> np.ndarray:
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h, w), np.uint8)
    base = (base.reshape(h // 4, 4, w // 4, 4).mean((1, 3))
            .astype(np.uint8).repeat(4, 0).repeat(4, 1))
    uvb = rng.integers(96, 160, (h // 2, w), np.uint8)
    return np.stack([np.concatenate([np.roll(base, 2 * i, 1), np.roll(uvb, 2 * i, 1)], 0)
                     for i in range(n)])


def _shear_frames(n: int, w: int, h: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h, w), np.uint8)
    base = (base.reshape(h // 4, 4, w // 4, 4).mean((1, 3))
            .astype(np.uint8).repeat(4, 0).repeat(4, 1))
    uvb = rng.integers(96, 160, (h // 2, w), np.uint8)
    out = []
    for i in range(n):
        y = base.copy()
        y[:h // 2 + 8] = np.roll(base[:h // 2 + 8], 3 * i, 1)
        y[h // 2 + 8:] = np.roll(base[h // 2 + 8:], -3 * i, 1)
        out.append(np.concatenate([y, np.roll(uvb, 2 * i, 1)], 0))
    return np.stack(out)


CFG = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                     chroma=ChromaPolicy.PASSTHROUGH)
SPEC = FrameSpec(width=W, height=H, fps=30)
# GOP-per-rank: (encoder options, frames); one GOP a rank, but for the
# ragged tail (two GOPs a rank, the last rank's second one short) and the
# intra encoder (ragged: 10 frames over 4 ranks)
MESH_CASES = {
    "search": (dict(gop=3, search=2), RANKS * 3),
    "fastsub": (dict(gop=3, search=2, fastsub=True), RANKS * 3),
    "refs2": (dict(gop=4, search=2, refs=2), RANKS * 4),
    "deblock": (dict(gop=3, deblock=True), RANKS * 3),
    "bitpack": (dict(gop=3, search=2, bitpack=True, nw_mb=64), RANKS * 3),
    "parts": (dict(gop=3, search=2, parts=True), RANKS * 3),
    "parts_refs2": (dict(gop=3, search=2, refs=2, parts=True), RANKS * 3),
    "ragged_two_gops_a_rank": (dict(gop=3, search=2), RANKS * 2 * 3 - 5),
    "intra": ({}, 10),
}
BANDED_CASES = {
    "full": dict(search=4),
    "half": dict(search=4, halfpel=True),
    "qpel": dict(search=2, quarterpel=True),
    "parts": dict(search=4, parts=True),
    "overlap": dict(search=4, overlap=True),
    "refs2": dict(search=3, refs=2),
    "parts_refs2": dict(search=3, refs=2, parts=True),
}
# (width, height, options): the banded encoder's refusals
BANDED_REFUSALS = {"search": (BW, BH, dict(gop=4, search=0)),
                   "divisible": (W, H, dict(gop=4, search=4))}


def _cases() -> list[dict]:
    cases = [dict(mode="levels" if name == "intra" else "gop", cfg=CFG, spec=SPEC,
                  enc=enc, qp=QP, frames=_frames(n))
             for name, (enc, n) in MESH_CASES.items()]
    bspec = FrameSpec(width=BW, height=BH, fps=30)
    cases += [dict(mode="banded", spec=bspec, enc=dict(gop=BN, **kw), qp=QP,
                   frames=_shear_frames(BN, BW, BH)) for kw in BANDED_CASES.values()]
    cases += [dict(mode="banded", spec=FrameSpec(width=w, height=h, fps=30), enc=kw,
                   qp=QP, frames=_frames(1)[:0]) for w, h, kw in BANDED_REFUSALS.values()]
    return cases


def _single_card_aus(case: dict) -> list[bytes]:
    """The access units of the port's single-card encoder with a case's
    options (``device="cpu"``), on the frames the single-card step
    enhanced for the GOP-per-rank modes."""
    spec, frames = case["spec"], case["frames"]
    if case["mode"] == "levels":
        enc = CudaCavlcEncoder(spec.width, spec.height, qp=QP, device="cpu", **case["enc"])
    else:
        enc = CudaGopEncoder(spec.width, spec.height, qp=QP, device="cpu", **case["enc"])
    if case["mode"] != "banded":
        frames = build_enhance_fn(case["cfg"], spec, donate=False)(
            torch.from_numpy(frames)).numpy()
    return [au for f in frames for au in enc.encode(f)] + enc.flush()


JAX_CFG = JaxConfig(op="none", chroma=JaxChroma.PASSTHROUGH)
JAX_SPEC = JaxSpec(width=W, height=H, fps=30)


def _enhanced(frames: np.ndarray) -> np.ndarray:
    return build_enhance_fn(CFG, SPEC, donate=False)(torch.from_numpy(frames)).numpy()


def _jax_packed(fn, sharding, unit, frames):
    padded, real = jax_sharded.pad_batch_for_mesh(_enhanced(frames), RANKS, unit)
    return np.asarray(fn(jax.device_put(padded, sharding), jnp.int32(QP)))[:real]


def _jax_results() -> dict:
    """The JAX package's builders and banded encoder on its 2x2 CPU mesh:
    the packed lanes of the ragged GOP case and the intra case (the port's
    enhanced frames with ``op="none"``), the banded ``search=4`` AUs."""
    mesh = jax_make_mesh(shape=(2, 2))
    enc_kw, n = MESH_CASES["ragged_two_gops_a_rank"]
    out = {"gop": _jax_packed(*jax_sharded.build_mesh_gop_fn(
        JAX_CFG, JAX_SPEC, enc_kw["gop"], mesh, search=enc_kw["search"]), _frames(n))}
    fn, sharding, unit = jax_sharded.build_mesh_levels_fn(JAX_CFG, JAX_SPEC, mesh)
    out["levels"] = (unit, _jax_packed(fn, sharding, unit, _frames(MESH_CASES["intra"][1])))
    enc = jax_sharded.BandedTpuGopEncoder(BW, BH, mesh, qp=QP, gop=BN,
                                          **BANDED_CASES["full"])
    out["banded"] = [au for f in _shear_frames(BN, BW, BH) for au in enc.encode(f)]
    out["banded"] += enc.flush()
    return out


def _in_thread(fn) -> tuple[threading.Thread, dict]:
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised by the fixture
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    return thread, box


@pytest.fixture(scope="module")
def runs():
    """Every case on the 2x2 gloo group, by name: rank 0's result (``all``:
    every rank's) with ``single``, the single-card encoder's access units;
    and ``jax``, the JAX package's results.  The single-card encoders run in
    a thread of this process and the JAX programs in this one while the
    group runs."""
    cases = _cases()
    names = (list(MESH_CASES) + [f"banded_{k}" for k in BANDED_CASES]
             + [f"refusal_{k}" for k in BANDED_REFUSALS])
    group = _in_thread(lambda: launch.run_on_mesh(
        (2, 2), launch.compare_with_encoder, (cases, False), device_type="cpu",
        timeout=300.0))
    singles = _in_thread(lambda: {name: _single_card_aus(case)
                                  for name, case in zip(names, cases)
                                  if not name.startswith("refusal_")})
    try:
        jax_out = _jax_results()
    finally:
        for thread, _ in (group, singles):
            thread.join(timeout=330.0)
    for thread, box in (group, singles):
        assert not thread.is_alive()
        if "error" in box:
            raise box["error"]
    ranks, single = group[1]["value"], singles[1]["value"]
    out = {name: {**ranks[0][i], "single": single.get(name),
                  "all": [r[i] for r in ranks]} for i, name in enumerate(names)}
    out["jax"] = jax_out
    return out


def test_mesh_gop_packed_and_aus_equal_jax(runs):
    enc_kw, n = MESH_CASES["ragged_two_gops_a_rank"]
    want = runs["jax"]["gop"]
    got = runs["ragged_two_gops_a_rank"]
    assert got["packed"].dtype == np.int16 and got["packed"].shape == (n, 3, 4, 412)
    np.testing.assert_array_equal(got["packed"], want)
    jax_enc = TpuGopEncoder(W, H, qp=QP, **enc_kw)
    assert got["aus"] == [au for p in want for au in jax_enc.encode_from_packed(p)]


def test_mesh_levels_packed_and_aus_equal_jax(runs):
    unit, want = runs["jax"]["levels"]
    got = runs["intra"]
    assert unit == 1 and got["packed"].shape == (10, 3, 4, 410)
    np.testing.assert_array_equal(got["packed"], want)
    jax_enc = TpuCavlcEncoder(W, H, qp=QP)
    assert got["aus"] == [au for p in want for au in jax_enc.encode_from_packed(p)]


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_byte_identical_to_the_single_card_encoder(name, runs):
    got = runs[name]
    assert got["aus"] == got["single"]
    assert len(got["aus"]) == MESH_CASES[name][1]
    assert all(r["backend"] == "gloo" and not r["loaded"] for r in got["all"])
    assert all(r.get("aus") is None and r.get("packed") is None for r in got["all"][1:])


def test_banded_aus_equal_jax(runs):
    assert runs["banded_full"]["aus"] == runs["jax"]["banded"]
    assert len(runs["jax"]["banded"]) == BN


@pytest.mark.parametrize("name", list(BANDED_CASES))
def test_banded_byte_identical_to_the_single_card_encoder(name, runs):
    got = runs[f"banded_{name}"]
    assert got["aus"] == got["single"] and len(got["aus"]) == BN
    assert all(r.get("aus") is None for r in got["all"][1:])
    assert all(len(r["ms"]["frames"]) == BN for r in got["all"])


@pytest.mark.parametrize("name", list(BANDED_REFUSALS))
def test_banded_refusals_are_the_jax_classes(name, runs):
    w, h, kw = BANDED_REFUSALS[name]
    with pytest.raises(ValueError, match=name) as want:
        jax_sharded.BandedTpuGopEncoder(w, h, jax_make_mesh(shape=(2, 2)), **kw)
    assert [r["error"] for r in runs[f"refusal_{name}"]["all"]] == [str(want.value)] * 4


@pytest.mark.parametrize("n,ndev,unit", [(19, 4, 3), (12, 4, 3), (1, 4, 1), (7, 2, 2)])
def test_pad_batch_for_mesh_equals_jax(n, ndev, unit):
    frames = _frames(n)
    got, real = sharded_encode.pad_batch_for_mesh(frames, ndev, unit)
    want, jax_real = jax_sharded.pad_batch_for_mesh(frames, ndev, unit)
    assert real == jax_real == n
    np.testing.assert_array_equal(got, want)
    assert len(got) % (ndev * unit) == 0


def test_a_failure_on_one_rank_fails_every_rank(capfd):
    """A step that raises on rank 1 alone raises on both ranks of a gloo
    group, and the relay's ``--mesh=2x1 --fused-encode`` whose step fails on
    rank 1 at its second batch returns 1 on both ranks, rank 0 saying why;
    no rank waits in a collective for the other (the call ends well inside
    its timeout)."""
    from tests import mesh_faults

    argv = ["--source=test", "--width=64", "--height=48", "--op=histeq",
            "--chroma=gray", "--batch=2", "--max-frames=12", "--status-interval=60",
            "--sink=rtp+h264://127.0.0.1:56492", "--encoder=tpu:qp=40", "--mesh=2x1",
            "--fused-encode", "--device=cpu"]
    ranks = launch.run_on_mesh((2, 1), mesh_faults.fail_on_rank_1, (argv,),
                               device_type="cpu", timeout=110.0)
    err = capfd.readouterr().err
    assert ranks[0]["agreed"] == "RuntimeError: the step failed on 1 other rank(s) of the mesh"
    assert ranks[1]["agreed"] == "ValueError: injected on rank 1"
    assert [r["rc"] for r in ranks] == [1, 1]
    assert all(r["steps"] == 3 for r in ranks)   # the warm-up, one batch, the failure
    assert "the fused mesh step failed: the step failed on 1 other rank(s)" in err

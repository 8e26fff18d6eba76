"""The port's device GOP encoder (``io.h264_inter.CudaGopEncoder``) on the
CPU against the host oracle and the JAX package's ``TpuGopEncoder``.

``CudaGopEncoder(device="cpu")`` runs the kernels' plain versions; its
access units equal ``GopCavlcEncoder(slices=mb_h)``'s byte for byte for
``gop``, ``gdr``, ``search`` with each sub-pel mode, ``refs=2``,
``deblock``, ``cpb``, rate control and ``i4`` / ``chromah`` IDRs, and their
compositions (the cases of ``tests/test_h264_inter_tpu.py`` and
``tests/test_h264_deblock_tpu.py``'s ``TestTpuGopDeblock``).  ``overlap``
gives the same bytes one frame late and ``flush`` drains it;
``native="require"`` equals ``native="never"``; one configuration equals
the JAX ``TpuGopEncoder`` itself.  The factory builds the class for
``tpu:gop=N`` and ``tpu:gdr=N`` and refuses as the reference does (the
partition modes and the bit packer: ``tests/test_torch_h264_parts.py`` and
``tests/test_torch_h264_bitpack.py``).
"""

import numpy as np
import pytest
import torch

from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
from opencv_opencl_tpu_torch import native
from opencv_opencl_tpu_torch.io import encoder
from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder, GopCavlcEncoder
from tests.test_h264_inter import (moving_frames, panning_frames,
                                   quarterpel_panning_frames, subpel_panning_frames)


def gop_frames(w, h, n, seed=0):
    """Static background, a moving insert and one scene cut: skip, inter
    and intra MBs all occur."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
    out = []
    for i in range(n):
        f = base.copy()
        if i >= 1:
            f[5:25, 8 + 4 * i:40 + 4 * i] = rng.integers(0, 256, (20, 32), np.uint8)
        if i == n - 2:
            f[:h // 2] = rng.integers(0, 256, (h // 2, w), np.uint8)
        out.append(f)
    return out


def hgrad_cut(w, h, n, seed=0):
    """Static noise, then a scene cut to rows of one value each on every P
    frame: I_16x16 HORIZONTAL (mode 3) wins in P frames."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
    base[h:] = 128
    grad = np.repeat(np.linspace(20, 235, h).astype(np.uint8)[:, None], w, 1)
    out = [base.copy() for _ in range(n)]
    for f in out[1:]:
        f[:h] = grad
    return out


def fuzz_frames(w, h, n, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
    out = []
    for i in range(n):
        f = np.concatenate([np.roll(base[:h], (2 * i, -i), (0, 1)), base[h:]], 0)
        if i == n - 2:
            f[h // 2:h] = rng.integers(0, 256, (h - h // 2, w), np.uint8)
        out.append(f)
    return out


def encode_all(enc, frames):
    return [au for f in frames for au in enc.encode(f)] + enc.flush()


# (id, width, height, frames, encoder options)
CASES = [
    ("gop", 96, 64, lambda: gop_frames(96, 64, 6, seed=28), dict(qp=28, gop=3)),
    ("gop_unaligned", 100, 56, lambda: gop_frames(100, 56, 5, seed=35), dict(qp=35, gop=3)),
    ("search", 96, 64, lambda: panning_frames(96, 64, 4, step=4), dict(qp=28, gop=5, search=8)),
    ("search_mixed", 64, 48, lambda: moving_frames(64, 48, 5, seed=3),
     dict(qp=30, gop=3, search=2)),
    ("halfpel", 64, 48, lambda: subpel_panning_frames(64, 48, 4),
     dict(qp=28, gop=4, search=2, halfpel=True)),
    ("quarterpel", 64, 48, lambda: quarterpel_panning_frames(64, 48, 4),
     dict(qp=28, gop=4, search=2, quarterpel=True)),
    ("fastsub", 64, 48, lambda: quarterpel_panning_frames(64, 48, 4, seed=1),
     dict(qp=28, gop=4, search=3, fastsub=True)),
    ("fastsub_refs2", 64, 48, lambda: moving_frames(64, 48, 5, seed=6),
     dict(qp=30, gop=5, search=2, fastsub=True, refs=2)),
    ("refs2", 64, 48, lambda: moving_frames(64, 48, 5, seed=7),
     dict(qp=30, gop=5, search=2, refs=2)),
    ("refs2_quarterpel", 64, 48, lambda: moving_frames(64, 48, 4, seed=8),
     dict(qp=30, gop=4, search=1, quarterpel=True, refs=2)),
    ("deblock", 64, 48, lambda: moving_frames(64, 48, 5, seed=1),
     dict(qp=28, gop=3, deblock=True)),
    ("deblock_quarterpel", 64, 48, lambda: moving_frames(64, 48, 5, seed=3),
     dict(qp=28, gop=3, search=2, quarterpel=True, deblock=True)),
    ("deblock_refs2", 64, 48, lambda: moving_frames(64, 48, 5, seed=4),
     dict(qp=28, gop=3, search=2, quarterpel=True, refs=2, deblock=True)),
    ("deblock_rate_control", 64, 48, lambda: moving_frames(64, 48, 6, seed=4),
     dict(qp=34, gop=3, deblock=True, bitrate_kbps=300, fps=30.0)),
    ("gdr", 64, 64, lambda: gop_frames(64, 64, 7, seed=2), dict(qp=30, gdr=3)),
    ("gdr_search", 64, 64, lambda: moving_frames(64, 64, 6, seed=2),
     dict(qp=30, gdr=3, search=2)),
    ("gdr_fastsub", 64, 64, lambda: moving_frames(64, 64, 5, seed=5),
     dict(qp=30, gdr=2, search=2, fastsub=True)),
    ("gdr_deblock_slice_local", 64, 64, lambda: moving_frames(64, 64, 6, seed=9),
     dict(qp=30, gdr=3, search=1, deblock=True)),
    ("cpb", 64, 48, lambda: gop_frames(64, 48, 6, seed=5),
     dict(qp=30, gop=3, search=1, bitrate_kbps=100, fps=30.0, cpb_ms=300)),
    ("cpb_initdelay_deblock", 64, 48, lambda: moving_frames(64, 48, 5, seed=5),
     dict(qp=26, gop=3, bitrate_kbps=150, fps=30.0, cpb_ms=400,
          initial_delay_ms=100, deblock=True)),
    ("i4_chromah_idr", 64, 48, lambda: gop_frames(64, 48, 5, seed=11),
     dict(qp=26, gop=2, search=1, i4=True, chromah=True)),
    ("intra_horizontal_in_p", 96, 64, lambda: hgrad_cut(96, 64, 3, seed=2),
     dict(qp=30, gop=10)),
    ("fuzz_10", 80, 48, lambda: fuzz_frames(80, 48, 5, 10),
     dict(qp=27, gop=4, search=3, halfpel=True, refs=2)),
    ("fuzz_11", 48, 64, lambda: fuzz_frames(48, 64, 5, 11),
     dict(qp=36, gop=3, search=2, quarterpel=True)),
    ("one_mb_row", 96, 16, lambda: fuzz_frames(96, 16, 4, 12),
     dict(qp=30, gop=3, search=2, quarterpel=True, refs=2, deblock=True)),
    ("one_mb_column", 16, 64, lambda: fuzz_frames(16, 64, 4, 13),
     dict(qp=30, gdr=2, search=2, fastsub=True, deblock=True)),
]


@pytest.mark.parametrize("w,h,make,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_stream_equals_the_host_oracle(w, h, make, kw):
    frames = make()
    mb_h = -(-h // 16)
    got = encode_all(CudaGopEncoder(w, h, device="cpu", **kw), frames)
    want = encode_all(GopCavlcEncoder(w, h, slices=mb_h, **kw), frames)
    assert len(got) == len(frames)
    assert got == want


def test_intra_horizontal_in_p_is_chosen():
    w, h = 96, 64
    enc = CudaGopEncoder(w, h, qp=30, gop=10, device="cpu")
    frames = hgrad_cut(w, h, 3, seed=2)
    pend = []
    for f in frames:
        pend.append(enc._dispatch(f))
    assert pend[1][0] == "p" and (pend[1][1][1]["mode"] == 3).any()


@pytest.mark.parametrize("kw", [dict(gop=3), dict(gop=3, search=2, deblock=True),
                                dict(gdr=2, search=1)], ids=["gop", "search_deblock", "gdr"])
def test_overlap_shifts_by_one_frame_bytes_unchanged(kw):
    w, h = 96, 64
    frames = gop_frames(w, h, 5, seed=3)
    sync = CudaGopEncoder(w, h, qp=30, device="cpu", **kw)
    want = [au for f in frames for au in sync.encode(f)]
    pipe = CudaGopEncoder(w, h, qp=30, overlap=True, device="cpu", **kw)
    assert pipe.encode(frames[0]) == []
    got = [au for f in frames[1:] for au in pipe.encode(f)]
    got += pipe.flush()
    assert got == want
    assert pipe.flush() == []


def test_native_require_equals_never():
    if not native.available():
        pytest.skip(f"the native library does not build here: {native.build_error()}")
    w, h = 64, 48
    frames = moving_frames(w, h, 5, seed=2)
    kw = dict(qp=28, gop=3, search=2, quarterpel=True, refs=2, deblock=True, device="cpu")
    got = encode_all(CudaGopEncoder(w, h, native="require", **kw), frames)
    assert got == encode_all(CudaGopEncoder(w, h, native="never", **kw), frames)
    kw = dict(qp=30, gdr=3, search=1, deblock=True, device="cpu")
    got = encode_all(CudaGopEncoder(w, 64, native="require", **kw),
                     gop_frames(w, 64, 5, seed=2))
    assert got == encode_all(CudaGopEncoder(w, 64, native="never", **kw),
                             gop_frames(w, 64, 5, seed=2))


def test_stream_equals_jax_tpu_gop_encoder():
    """The JAX package's encoder on the same frames, zero motion."""
    w, h = 96, 64
    frames = gop_frames(w, h, 5, seed=4)
    got = encode_all(CudaGopEncoder(w, h, qp=30, gop=3, device="cpu"), frames)
    assert got == encode_all(TpuGopEncoder(w, h, qp=30, gop=3), frames)


def test_the_chain_stays_on_the_device_and_is_never_written():
    """The reference planes are the device's tensors, and a P frame makes
    new ones: the CPB loop's snapshot stays valid."""
    w, h = 64, 48
    enc = CudaGopEncoder(w, h, qp=30, gop=4, search=1, deblock=True, device="cpu")
    frames = moving_frames(w, h, 3, seed=1)
    enc.encode(frames[0])
    first = enc._recon
    copies = [p.clone() for p in first]
    enc.encode(frames[1])
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu" for p in enc._recon)
    assert all(a is not b for a, b in zip(enc._recon, first))
    assert all(torch.equal(a, b) for a, b in zip(first, copies))


@pytest.mark.parametrize("kw,msg", [
    (dict(gop=0), "gop must be >= 1"),
    (dict(gdr=3, search=2, refs=2), "gdr requires refs=1"),
    (dict(search=2, fastsub=True, halfpel=True), "replaces halfpel"),
    (dict(fastsub=True), "require search"),
    (dict(search=16), "search must be"),
    (dict(search=12, quarterpel=True), "radius must be <= 11"),
    (dict(search=2, refs=3), "refs must be 1 or 2"),
    (dict(refs=2), "requires search"),
    (dict(initial_delay_ms=100), "initdelay requires cpb"),
    (dict(cpb_ms=500), "cpb needs bitrate control"),
    (dict(cpb_ms=500, bitrate_kbps=400, overlap=True), "does not compose with overlap"),
    (dict(parts=True), "parts requires search"),
    (dict(parts=True, search=2, fastsub=True), "parts does not compose with fastsub"),
    (dict(bitpack=True, parts=True, search=2, gdr=3), "parts requires no gdr"),
], ids=["gop0", "gdr_refs2", "fastsub_halfpel", "fastsub_no_search", "search16",
        "qpel_radius", "refs3", "refs2_no_search", "initdelay", "cpb_fixed_qp",
        "cpb_overlap", "parts_no_search", "parts", "bitpack"])
def test_refusals_equal_the_reference(kw, msg):
    with pytest.raises(ValueError, match=msg):
        CudaGopEncoder(64, 48, device="cpu", **kw)


def test_no_card_raises_and_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="runs on the card"):
        CudaGopEncoder(64, 48, gop=4)


@pytest.mark.parametrize("spec,kind", [
    ("tpu:qp=30:gop=4", dict(gop=4, search=0, subpel=0)),
    ("tpu:gop=8:search=2:fastsub:deblock", dict(gop=8, search=2, subpel=3, deblock=True)),
    ("tpu:qp=30:gdr=3:search=2:halfpel", dict(gdr=3, search=2, subpel=1)),
    ("tpu:gop=4:search=1:quarterpel:refs=2:overlap", dict(gop=4, refs=2, subpel=2)),
    ("tpu:gop=4:cpb=500:initdelay=100", dict(gop=4)),
], ids=["gop", "fastsub_deblock", "gdr_halfpel", "refs2_overlap", "cpb"])
def test_factory_builds_the_gop_encoder(spec, kind):
    enc = encoder.make_encoder(spec, 64, 48, bitrate_kbps=400, device="cpu")
    assert type(enc) is CudaGopEncoder and enc.device.type == "cpu"
    for key, value in kind.items():
        assert getattr(enc, key) == value, key
    assert enc.bitrate_kbps == (None if "qp=" in spec else 400)
    assert len(enc.encode(gop_frames(64, 48, 1)[0]) + enc.flush()) == 1

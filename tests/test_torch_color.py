"""The port's color conversions against the JAX package, its oracles and cv2.

``opencv_opencl_tpu_torch/core/color.py`` is a copy of the JAX package's
numpy oracles: each function, on one seeded image, must give the
original's output, and the fixed-point constants must be the same.
``opencv_opencl_tpu_torch/ops/color.py`` (plain PyTorch, int32 fixed point)
must equal ``opencv_opencl_tpu.ops.color`` on the same inputs, single and
batched, and cv2 where cv2 has the conversion.  Tolerance: 0 LSB (integer
arithmetic on every backend).
"""

import cv2
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import color as jax_oracle
from opencv_opencl_tpu.ops import color as jax_color
from opencv_opencl_tpu_torch.core import color as oracle
from opencv_opencl_tpu_torch.ops import color

torch.set_num_threads(1)

H, W = 64, 96


def _img(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _np(t: torch.Tensor) -> np.ndarray:
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
    return t.numpy()


# ------------------------------------------------------ core/color copy ----


def test_oracle_constants_equal_the_original():
    names = [n for n in vars(jax_oracle) if n.startswith("_") and n[1:].isupper()]
    assert len(names) == 25
    for name in names:
        assert getattr(oracle, name) == getattr(jax_oracle, name), name


@pytest.mark.parametrize("fn,make", [
    ("bgr2yuv", lambda: _img(1, H, W, 3)),
    ("yuv2bgr", lambda: _img(2, H, W, 3)),
    ("bgr2yuv_i420", lambda: _img(3, H, W, 3)),
    ("bgr2nv12", lambda: _img(4, H, W, 3)),
    ("nv12_to_bgr", lambda: _img(5, H * 3 // 2, W)),
    ("i420_to_nv12", lambda: _img(6, H * 3 // 2, W)),
    ("nv12_to_i420", lambda: _img(7, H * 3 // 2, W)),
])
def test_oracle_copy_equals_the_original(fn, make):
    x = make()
    got = getattr(oracle, fn)(x)
    assert got.dtype == np.uint8
    assert np.array_equal(got, getattr(jax_oracle, fn)(x))


# ------------------------------------------------------------ ops/color ----


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("fn,rows,cols,chan", [
    ("bgr2yuv", H, W, 3),
    ("yuv2bgr", H, W, 3),
    ("bgr2nv12", H, W, 3),
    ("nv12_to_bgr", H * 3 // 2, W, None),
    ("nv12_gray_chroma", H * 3 // 2, W, None),
])
def test_ops_equal_jax(fn, rows, cols, chan, batch):
    shape = (rows, cols) + ((chan,) if chan else ())
    x = _img(10, *(((batch,) if batch else ()) + shape))
    got = _np(getattr(color, fn)(x, device="cpu"))
    want = np.asarray(getattr(jax_color, fn)(x))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("batch", [None, 2])
def test_nv12_ops_take_an_explicit_height(batch):
    lead = (batch,) if batch else ()
    nv12 = _img(11, *lead, H * 3 // 2, W)
    for fn in ("nv12_to_bgr", "nv12_gray_chroma"):
        got = _np(getattr(color, fn)(nv12, H, device="cpu"))
        assert np.array_equal(got, np.asarray(getattr(jax_color, fn)(nv12, H)))
    y = _img(12, *lead, H, W)
    got = _np(color.nv12_set_y(nv12, y, device="cpu"))
    assert np.array_equal(got, np.asarray(jax_color.nv12_set_y(nv12, y)))


def test_ops_equal_cv2_and_the_oracles():
    bgr = _img(13, H, W, 3)
    yuv = _np(color.bgr2yuv(bgr, device="cpu"))
    assert np.array_equal(yuv, cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV))
    assert np.array_equal(_np(color.yuv2bgr(yuv, device="cpu")),
                          cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR))
    nv12 = _np(color.bgr2nv12(bgr, device="cpu"))
    assert np.array_equal(nv12, oracle.bgr2nv12(bgr))
    assert np.array_equal(_np(color.nv12_to_bgr(nv12, device="cpu")),
                          cv2.cvtColor(nv12, cv2.COLOR_YUV2BGR_NV12))


def test_ops_keep_extreme_values_in_range():
    """Saturated inputs: the int32 sums must clamp, never wrap as uint8."""
    corners = np.array([[[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]],
                       np.uint8).repeat(2, axis=0)
    for fn in ("bgr2yuv", "yuv2bgr"):
        got = _np(getattr(color, fn)(corners, device="cpu"))
        assert np.array_equal(got, np.asarray(getattr(jax_color, fn)(corners)))
    nv12 = np.zeros((6, 4), np.uint8)
    nv12[:4] = 255                      # Y at its maximum, chroma at 0
    assert np.array_equal(_np(color.nv12_to_bgr(nv12, device="cpu")),
                          np.asarray(jax_color.nv12_to_bgr(nv12)))


def test_ops_accept_tensors_and_return_on_the_device():
    bgr = torch.from_numpy(_img(14, 2, H, W, 3))
    out = color.bgr2yuv(bgr, device="cpu")
    assert out.device.type == "cpu" and out.shape == bgr.shape
    assert np.array_equal(out.numpy(), np.asarray(jax_color.bgr2yuv(bgr.numpy())))

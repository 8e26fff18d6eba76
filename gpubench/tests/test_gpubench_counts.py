"""The yardstick's bytes and operations, against the bounds that
``chip_smoke.py`` printed for the same kernels at 4K (PERF.md's table of
kernels), and its percentile."""

import pytest

from gpubench import yardstick as y

H, W = 2160, 3840
MBH, MBW = H // 16, W // 16


def test_clahe_frame_bound():
    px, hist, luts = H * W, 64 * 256 * 4, 64 * 256
    k1 = (px + hist) / y.PEAK_BYTES_PER_S
    k3 = (2 * px + luts + 12 * (H + W)) / y.PEAK_BYTES_PER_S
    assert y.clahe_frame_bound(H, W, 64) == pytest.approx(
        k1 + (hist + luts) / y.PEAK_BYTES_PER_S + k3)
    # the table's K1 and K3 bounds at 4K b4, 0.0100 and 0.0198 ms, which
    # count K3's per-row and per-column tables once a batch, not a frame
    assert 4 * k1 * 1e3 == pytest.approx(0.0100, rel=0.01)
    assert 4 * k3 * 1e3 == pytest.approx(0.0198, rel=0.01)


def test_p_frame_parts_match_the_table():
    planes, margin = y.search_plan(8, 3)
    assert (planes, margin) == (16, 9)
    assert y.search_candidates(8, 3) == 289 + 49
    stack = planes * (H + 2 * margin) * (W + 2 * margin)
    h3 = y.bound(H * W + stack, y.planes_ops(H + 2 * margin, W + 2 * margin, planes))
    h4 = y.bound(0, 3 * y.search_candidates(8, 3) * H * W)
    assert h3 * 1e3 == pytest.approx(0.0426, abs=5e-5)     # H3, by bytes
    assert h4 * 1e3 == pytest.approx(0.1255, abs=5e-5)     # H4, by operations
    assert y.deblock_ops(MBH, MBW) / y.PEAK_OPS_PER_S < 0.0077e-3 * 1.01
    total = y.p_frame_bound(H, W, 8, 3, True)
    assert 0.18e-3 < total < 0.21e-3


def test_idr_and_full_pel_bounds():
    assert y.idr_frame_bound(H, W, False) < y.idr_frame_bound(H, W, True)
    assert y.p_frame_bound(H, W, 0, 0, False) == pytest.approx(
        y.bound(3 * 3 * H * W // 2 + 2 * y.P_WORDS_MB * MBH * MBW, y.p_ops(MBH, MBW)))
    assert y.search_candidates(4, 2) == 33 ** 2 and y.search_plan(4, 1) == (4, 5)


@pytest.mark.parametrize("values,pct,want", [
    (list(range(1, 101)), 99, 99), (list(range(1, 101)), 50, 50), ([3.0], 99, 3.0),
    ([5, 1, 4, 2, 3], 100, 5),
])
def test_nearest_rank(values, pct, want):
    assert y.nearest_rank(values, pct) == want

"""The port's image and video apps against the JAX package's.

``histeq_image``, ``clahe_image``, ``m2_bench``, ``parity_bench``,
``clahe_video`` and ``airplan_mp4`` of both packages run on the same
generated inputs (a 64x48 PNG as tests/test_apps.py's ``small_png``, and
short clips written with cv2), the port's with ``--device=cpu``, where the
kernels' wrappers run their plain versions:

- histeq outputs (files, frames, datagrams) are byte-equal to the JAX
  app's; CLAHE outputs are within ``assert_clahe_close`` of the JAX app's
  (the JAX CPU backend FMA-contracts the blend and flips exact ties by 1
  LSB, tests/conftest.py) and equal to ``core/golden.py`` exactly;
- printed lines and return codes are the JAX app's, with the timings
  masked and the one wording divergence of these apps mapped
  (``GPU {op} time`` for ``TPU {op} time`` in ``parity_bench``);
- the compute parts that ``chip_smoke.py`` drives on the card
  (``enhance_bgr``, ``clahe_bgr``, ``method1``/``method2``,
  ``device_parity``, ``enhance_frames``) against golden;
- without a card every app that launches a kernel fails with "no CUDA
  device" unless it gets ``--device=cpu``, and writes nothing.
"""

import os
import re

import cv2
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.apps import airplan_mp4 as jax_airplan_mp4
from opencv_opencl_tpu.apps import clahe_image as jax_clahe_image
from opencv_opencl_tpu.apps import clahe_video as jax_clahe_video
from opencv_opencl_tpu.apps import histeq_image as jax_histeq_image
from opencv_opencl_tpu.apps import m2_bench as jax_m2_bench
from opencv_opencl_tpu.apps import parity_bench as jax_parity_bench
from opencv_opencl_tpu.io import gst_adapter as jax_gst_adapter
from opencv_opencl_tpu.io import videofile as jax_videofile
from opencv_opencl_tpu_torch.apps import (
    airplan_mp4, clahe_image, clahe_video, histeq_image, m2_bench, parity_bench)
from opencv_opencl_tpu_torch.core import color as color_oracle
from opencv_opencl_tpu_torch.core import golden
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.io import gst_adapter, videofile
from opencv_opencl_tpu_torch.metrics.timing import TimingStats
from opencv_opencl_tpu_torch.models.enhancer import Enhancer, EnhancerConfig
from tests.conftest import assert_clahe_close
from tests.test_torch_apps import _driven_bridge
from tests.test_torch_encoded_relay import catchers, drain

torch.set_num_threads(1)
CPU = torch.device("cpu")


def masked(text: str) -> list[str]:
    """The lines of ``text`` with the timings masked and the port's wording
    mapped to the JAX app's."""
    text = re.sub(r"GPU (\w+) time", r"TPU \1 time", text)
    text = re.sub(r"\d+\.\d+", "F", text)
    text = re.sub(r"\d+ μs", "N μs", text)
    return text.splitlines()


def run_both(port_app, jax_app, argv, capsys, extra=("--device=cpu",)):
    """``run`` of both apps on ``argv`` (the port's with ``extra``): their
    return codes and printed (stdout, stderr), the JAX app's second."""
    got = port_app.run(list(argv) + list(extra))
    ours = capsys.readouterr()
    want = jax_app.run(list(argv))
    theirs = capsys.readouterr()
    return (got, ours), (want, theirs)


def assert_same_print(ours, theirs):
    assert masked(ours.out) == masked(theirs.out)
    assert masked(ours.err) == masked(theirs.err)


@pytest.fixture
def small_png(tmp_path, rng):
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    p = str(tmp_path / "small.png")
    cv2.imwrite(p, img)
    return p


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 6-frame 64x48 mp4v clip, and its NV12 frames as ``FileSource``
    decodes them."""
    rng = np.random.default_rng(17)
    path = str(tmp_path_factory.mktemp("clip") / "in.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    assert w.isOpened(), "cv2 VideoWriter unavailable"
    for _ in range(6):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()
    src = videofile.FileSource(path, width=64, height=48)
    frames = list(src)
    src.close()
    assert len(frames) == 6
    return path, frames


def golden_bgr(bgr, enhance_y):
    yuv = color_oracle.bgr2yuv(bgr)
    merged = np.stack([enhance_y(yuv[..., 0]), yuv[..., 1], yuv[..., 2]], axis=-1)
    return color_oracle.yuv2bgr(merged)


# ------------------------------------------------------------ the images ----


@pytest.mark.parametrize("name", ["histeq_image", "m2_bench"])
def test_histeq_apps_write_the_jax_apps_file_and_lines(name, small_png, tmp_path,
                                                       capsys):
    port_app, jax_app = {"histeq_image": (histeq_image, jax_histeq_image),
                         "m2_bench": (m2_bench, jax_m2_bench)}[name]
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    got = port_app.run([small_png, ours, "--device=cpu"])
    out_ours = capsys.readouterr()
    want = jax_app.run([small_png, theirs])
    out_theirs = capsys.readouterr()
    assert got == want == 0
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert masked(out_ours.out.replace(ours, theirs)) == masked(out_theirs.out)
    assert out_ours.err == out_theirs.err == ""
    bgr = cv2.imread(small_png)
    assert np.array_equal(cv2.imread(ours), golden_bgr(bgr, golden.equalize_hist))


@pytest.mark.parametrize("name", ["histeq_image", "m2_bench"])
@pytest.mark.parametrize("argv", [[], ["one.png"], ["a.png", "b.png", "c.png"],
                                  ["missing.png", "out.png"]],
                         ids=["none", "one", "three", "missing"])
def test_positional_apps_refuse_as_the_jax_apps(name, argv, capsys, tmp_path,
                                                monkeypatch):
    port_app, jax_app = {"histeq_image": (histeq_image, jax_histeq_image),
                         "m2_bench": (m2_bench, jax_m2_bench)}[name]
    monkeypatch.chdir(tmp_path)
    (got, ours), (want, theirs) = run_both(port_app, jax_app, argv, capsys)
    assert got == want == -1
    assert (ours.out, ours.err) == (theirs.out, theirs.err)
    assert not list(tmp_path.iterdir())


def test_enhance_bgr_stages_and_m2_methods_equal_golden(rng):
    bgr = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    want = golden_bgr(bgr, golden.equalize_hist)
    out, stage_us = histeq_image.enhance_bgr(bgr, CPU)
    assert np.array_equal(out, want)
    assert list(stage_us) == list(histeq_image.STAGES)
    yuv = m2_bench.to_yuv(bgr, CPU)
    m1, _ = m2_bench.method1(yuv, CPU)
    m2, _ = m2_bench.method2(yuv, CPU)
    assert torch.equal(m1, m2)
    assert np.array_equal(color_oracle.yuv2bgr(m1.numpy()), want)


@pytest.mark.parametrize("clip_limit,tile,shape", [
    (2.0, 4, (48, 64)), (2.5, 3, (48, 64)), (3.0, 4, (47, 63))])
def test_clahe_image_equals_the_jax_app_and_golden(clip_limit, tile, shape, rng,
                                                   tmp_path, monkeypatch, capsys):
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    src = str(tmp_path / "in.png")
    cv2.imwrite(src, img)
    outs = {}
    for side, app in (("ours", clahe_image), ("theirs", jax_clahe_image)):
        os.mkdir(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        args = [f"--input={src}", f"--clipLimit={clip_limit}", f"--tileGridSize={tile}"]
        assert app.run(args + (["--device=cpu"] if side == "ours" else [])) == 0
        outs[side] = capsys.readouterr()
    name = clahe_image.output_name(src, clip_limit, tile)
    assert name == jax_clahe_image.output_name(src, clip_limit, tile)
    assert os.listdir(tmp_path / "ours") == os.listdir(tmp_path / "theirs") == [name]
    assert_same_print(outs["ours"], outs["theirs"])
    assert outs["ours"].out.startswith("CLAHE_apply_time_ms=")
    ours = cv2.imread(str(tmp_path / "ours" / name))
    assert_clahe_close(ours, cv2.imread(str(tmp_path / "theirs" / name)))
    want = golden_bgr(img, lambda y: golden.clahe(y, clip_limit, (tile, tile)))
    assert np.array_equal(ours, want)
    out, ms = clahe_image.clahe_bgr(img, clip_limit, tile, CPU)
    assert np.array_equal(out, want) and ms >= 0


@pytest.mark.parametrize("argv", [
    [], ["--input=x.png", "--clipLimit=0"], ["--input=x.png", "--tileGridSize=0"],
    ["--input=missing.png"]], ids=["none", "clip0", "tile0", "missing"])
def test_clahe_image_refuses_as_the_jax_app(argv, capsys):
    (got, ours), (want, theirs) = run_both(clahe_image, jax_clahe_image, argv,
                                           capsys)
    assert got == want == 1
    assert (ours.out, ours.err) == (theirs.out, theirs.err)


@pytest.mark.parametrize("extra,rc", [
    (["--op=histeq"], 0), (["--op=clahe", "--clipLimit=2.0", "--tile=4"], 0),
    (["--op=histeq", "--threshold=-1"], 1)], ids=["histeq", "clahe", "mismatch"])
def test_parity_bench_prints_the_jax_apps_lines(extra, rc, small_png, capsys):
    argv = [f"--input={small_png}", "--repeat=2"] + extra
    (got, ours), (want, theirs) = run_both(parity_bench, jax_parity_bench, argv,
                                           capsys)
    assert got == want == rc
    if "--op=clahe" in extra:
        # cv2 is the reference here: the port is exact, the JAX CPU backend
        # may flip a tie by 1 LSB
        assert "Max absolute difference: 0 LSB" in ours.out
        theirs = theirs._replace(out=re.sub(r"difference: [01] LSB",
                                            "difference: 0 LSB", theirs.out))
    assert_same_print(ours, theirs)
    assert "GPU " in ours.out and "TPU " not in ours.out


def test_parity_bench_dumps_the_jax_apps_images(small_png, tmp_path, monkeypatch,
                                                capsys):
    dumps = {}
    for side, app in (("ours", parity_bench), ("theirs", jax_parity_bench)):
        os.mkdir(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        args = [f"--input={small_png}", "--repeat=1", "--dump-images"]
        assert app.run(args + (["--device=cpu"] if side == "ours" else [])) == 0
        assert "Saved: input_y.jpg" in capsys.readouterr().out
        dumps[side] = {p: (tmp_path / side / p).read_bytes()
                       for p in sorted(os.listdir(tmp_path / side))}
    assert list(dumps["ours"]) == ["input_y.jpg", "out_diff_y.jpg", "out_ocv_y.jpg",
                                   "out_tpu_y.jpg"]
    assert dumps["ours"] == dumps["theirs"]


@pytest.mark.parametrize("argv", [[], ["--input=missing.png"],
                                  ["--input=PNG", "--op=sobel"]],
                         ids=["none", "missing", "unknown-op"])
def test_parity_bench_refuses_as_the_jax_app(argv, small_png, capsys):
    argv = [a.replace("PNG", small_png) for a in argv]
    (got, ours), (want, theirs) = run_both(parity_bench, jax_parity_bench, argv,
                                           capsys)
    assert got == want == -1
    assert (ours.out, ours.err) == (theirs.out, theirs.err)


@pytest.mark.parametrize("op", ["histeq", "clahe"])
def test_device_parity_against_golden_is_exact(op, rng):
    y = rng.integers(0, 256, (38, 54), dtype=np.uint8)
    want = golden.equalize_hist(y) if op == "histeq" else golden.clahe(y, 2.0, (4, 4))
    out, ms, err = parity_bench.device_parity(y, want, op, CPU, 2.0, 4, 0, repeat=2)
    assert np.array_equal(out, want) and err == 0.0 and ms >= 0.0
    _, _, err = parity_bench.device_parity(y, 255 - want, op, CPU, 2.0, 4, 0, repeat=1)
    assert err > 0.0
    with pytest.raises(ValueError):
        parity_bench.device_parity(y, want, "sobel", CPU)


# ------------------------------------------------------------- the video ----


def test_clahe_video_histeq_file_leg_equals_the_jax_app(clip, tmp_path, capsys):
    path, _ = clip
    outs, texts = {}, {}
    for side, app in (("ours", clahe_video), ("theirs", jax_clahe_video)):
        outs[side] = str(tmp_path / f"{side}.mp4")
        args = [f"--input={path}", f"--output={outs[side]}", "--resolution=64x48",
                "--op=histeq", "--chroma=gray", "--max-frames=5", "--detailed-timing"]
        assert app.run(args + (["--device=cpu"] if side == "ours" else [])) == 0
        texts[side] = capsys.readouterr()
    assert (tmp_path / "ours.mp4").read_bytes() == (tmp_path / "theirs.mp4").read_bytes()
    assert masked(texts["ours"].out.replace(outs["ours"], outs["theirs"])) == \
        masked(texts["theirs"].out)
    assert "MP4 saved (5 frames)" in texts["ours"].out
    assert texts["ours"].out.count("Frame ") == 5


def _recording_file_sinks(monkeypatch):
    """Record the NV12 frames each package's ``FileSink`` is given."""
    written = {}
    for mod in (videofile, jax_videofile):
        original = mod.FileSink.write
        written[mod] = []

        def write(self, nv12, _orig=original, _got=written[mod]):
            _got.append(np.array(nv12, copy=True))
            _orig(self, nv12)

        monkeypatch.setattr(mod.FileSink, "write", write)
    return written[videofile], written[jax_videofile]


def test_clahe_video_clahe_frames_equal_the_jax_app_and_golden(clip, tmp_path,
                                                              capsys, monkeypatch):
    path, frames = clip
    ours, theirs = _recording_file_sinks(monkeypatch)
    args = [f"--input={path}", f"--output={tmp_path / 'o.mp4'}",
            "--resolution=64x48", "--clipLimit=2.0", "--tile=4"]
    (got, out_ours), (want, out_theirs) = run_both(clahe_video, jax_clahe_video,
                                                   args, capsys)
    assert got == want == 0
    assert_same_print(out_ours, out_theirs)
    assert len(ours) == len(theirs) == 6
    for f, a, b in zip(frames, ours, theirs):
        assert_clahe_close(a, b)
        assert np.array_equal(a[:48], golden.clahe(f[:48], 2.0, (4, 4)))
        assert np.array_equal(a[48:], f[48:])


@pytest.mark.parametrize("ours,theirs", [
    (["--udp-kind=raw"], ["--udp-kind=raw"]),
    (["--udp-kind=h264", "--encoder=cavlc:qp=30"],
     ["--udp-kind=h264", "--encoder=cavlc:qp=30"]),
    (["--udp-kind=h264", "--encoder=tpu:qp=40"],
     ["--udp-kind=h264", "--encoder=cavlc:qp=40:slices=3"])],
    ids=["raw", "h264-mp4-tee", "tpu-h264-mp4-tee"])
def test_clahe_video_udp_legs_send_the_jax_apps_datagrams(ours, theirs, clip,
                                                          tmp_path, capsys,
                                                          monkeypatch):
    """The raw leg (the port's C++ packetizer, the JAX app's Python one), and
    the encoded leg with the same-encode mp4 tee: the same datagrams and the
    same mp4.  The device encoder (``tpu``, on ``--device``) sends what the
    host CAVLC encoder with one slice a MB row sends."""
    monkeypatch.setattr("opencv_opencl_tpu.native.available", lambda: False)
    path, _ = clip
    runs = []
    with catchers(1) as (port, (sock,)):
        for side, app, extra in (("ours", clahe_video, ours + ["--device=cpu"]),
                                 ("theirs", jax_clahe_video, theirs)):
            mp4 = str(tmp_path / f"{side}.mp4")
            args = [f"--input={path}", f"--output={mp4}", "--resolution=64x48",
                    "--op=histeq", f"--udp=127.0.0.1:{port}", "--max-frames=4"]
            assert app.run(args + extra) == 0
            text = capsys.readouterr()
            assert text.err == ""
            runs.append((drain(sock), masked(text.out.replace(mp4, "OUT"))))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) >= 4
    assert (tmp_path / "ours.mp4").read_bytes() == (tmp_path / "theirs.mp4").read_bytes()
    if "h264" in ours[0]:
        assert any("same-encode tee" in line for line in runs[0][1])


@pytest.mark.parametrize("argv", [[], ["--input=CLIP", "--udp=127.0.0.1:5004",
                                       "--udp-kind=h264", "--encoder=nope"]],
                         ids=["usage", "bad-encoder"])
def test_clahe_video_refuses_as_the_jax_app(argv, clip, capsys):
    argv = [a.replace("CLIP", clip[0]) for a in argv]
    (got, ours), (want, theirs) = run_both(clahe_video, jax_clahe_video, argv, capsys)
    assert got == want != 0
    assert (ours.out, ours.err) == (theirs.out, theirs.err)


@pytest.mark.parametrize("op", ["clahe", "histeq"])
def test_enhance_frames_on_test_source_frames_into_a_raw_sink(op, tmp_path, capsys):
    """The loop ``chip_smoke.py`` drives without cv2: ``TestSource`` frames,
    a ``RawSink``, every frame the plain step's and golden's."""
    spec = FrameSpec(width=64, height=48)
    cfg = EnhancerConfig(op=op, clip_limit=2.0, tile_grid=(4, 4),
                         chroma=ChromaPolicy.PASSTHROUGH)
    sink = videofile.RawSink(str(tmp_path / "o.nv12"))
    timing = TimingStats(window=8, label="t")
    frames = list(videofile.TestSource(spec, num_frames=5, seed=3))
    n = clahe_video.enhance_frames(iter(frames), Enhancer(cfg, spec, device="cpu"),
                                   [sink], timing, max_frames=4, detailed=True)
    sink.close()
    assert n == timing.frame_count == sink.frames == 4
    assert capsys.readouterr().out.count("Frame ") == 4
    got = np.fromfile(tmp_path / "o.nv12", np.uint8).reshape(4, 72, 64)
    for f, g in zip(frames, got):
        y = (golden.clahe(f[:48], 2.0, (4, 4)) if op == "clahe"
             else golden.equalize_hist(f[:48]))
        assert np.array_equal(g, np.concatenate([y, f[48:]]))


def test_airplan_mp4_forwards_to_clahe_video_as_the_jax_app(clip, tmp_path, capsys):
    path, _ = clip
    outs, texts = {}, {}
    for side, app in (("ours", airplan_mp4), ("theirs", jax_airplan_mp4)):
        outs[side] = str(tmp_path / f"{side}.mp4")
        args = [f"--input={path}", f"--output={outs[side]}", "--resolution=64x48",
                "--max-frames=3"]
        assert app.run(args + (["--device=cpu"] if side == "ours" else [])) == 0
        texts[side] = capsys.readouterr()
    assert (tmp_path / "ours.mp4").read_bytes() == (tmp_path / "theirs.mp4").read_bytes()
    assert masked(texts["ours"].out.replace(outs["ours"], outs["theirs"])) == \
        masked(texts["theirs"].out)
    (got, ours), (want, theirs) = run_both(airplan_mp4, jax_airplan_mp4, [], capsys)
    assert got == want == 1 and (ours.out, ours.err) == (theirs.out, theirs.err)


def test_airplan_mp4_io_gst_without_gi_refuses_as_the_jax_app(capsys, monkeypatch):
    for mod in (gst_adapter, jax_gst_adapter):
        monkeypatch.setattr(mod, "gi_available", lambda: False)
    (got, ours), (want, theirs) = run_both(airplan_mp4, jax_airplan_mp4,
                                           ["--input=a.mp4", "--io=gst"], capsys)
    assert got == want == 2
    assert (ours.out, ours.err) == (theirs.out, theirs.err)


@pytest.mark.parametrize("geometry", [["--width=64", "--height=48"], []],
                         ids=["given", "probed"])
def test_airplan_mp4_io_gst_builds_and_feeds_the_jax_apps_pipelines(
        geometry, clip, capsys, monkeypatch):
    """``--io=gst`` over ``tests/fake_gst.FakeGst`` in both packages: the same
    capture and emit pipelines, the timestamp policy ``COPY``, the same NV12
    buffers pushed with the same timestamps, and (without ``--width`` and
    ``--height``) the same geometry probed from the file with cv2."""
    from opencv_opencl_tpu.io.gst_adapter import GstAppBridge as JaxBridge
    from tests.fake_gst import FakeGst

    frames = np.random.default_rng(5).integers(0, 256, (4, 72, 64), np.uint8)
    made = {}
    for mod, bridge_cls in ((gst_adapter, gst_adapter.GstAppBridge),
                            (jax_gst_adapter, JaxBridge)):
        monkeypatch.setattr(mod, "gi_available", lambda: True)
        made[mod] = []
        monkeypatch.setattr(bridge_cls, "from_gi",
                            _driven_bridge(bridge_cls, FakeGst, frames, made[mod]))
    argv = [f"--input={clip[0]}", "--io=gst", "--host=127.0.0.1", "--port=5004",
            "--bitrate=4000"] + geometry
    (got, ours_text), (want, theirs_text) = run_both(airplan_mp4, jax_airplan_mp4,
                                                     argv, capsys)
    assert got == want == 0
    assert (ours_text.out, ours_text.err) == (theirs_text.out, theirs_text.err)
    assert "Done: 4 frames" in ours_text.out
    assert ("Probed input geometry: 64x48" in ours_text.out) == (not geometry)
    (ours,), (theirs,) = made[gst_adapter], made[jax_gst_adapter]
    assert ours.capture_desc == theirs.capture_desc
    assert ours.emit_desc == theirs.emit_desc
    assert ours.policy.value == theirs.policy.value == "copy"
    pushed = [[(b.data, b.pts, b.dts, b.duration) for b in bridge._appsrc.pushed]
              for bridge in (ours, theirs)]
    assert pushed[0] == pushed[1] and len(pushed[0]) == 4


# ---------------------------------------------------- without a card ----


NO_CARD = [(histeq_image, ["PNG", "out.png"]), (m2_bench, ["PNG", "out.png"]),
           (clahe_image, ["--input=PNG"]), (parity_bench, ["--input=PNG"]),
           (clahe_video, ["--input=CLIP", "--output=out.mp4"]),
           (airplan_mp4, ["--input=CLIP", "--output=out.mp4"])]


@pytest.mark.parametrize("app,argv", NO_CARD, ids=[a.__name__.split(".")[-1]
                                                   for a, _ in NO_CARD])
def test_kernel_apps_without_a_card_fail_and_do_not_fall_back(app, argv, small_png,
                                                              clip, capsys, tmp_path,
                                                              monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.chdir(tmp_path)
    before = sorted(os.listdir(tmp_path))
    argv = [a.replace("PNG", small_png).replace("CLIP", clip[0]) for a in argv]
    rc = app.run(argv)
    captured = capsys.readouterr()
    assert rc not in (0, 2)
    assert "no CUDA device" in captured.err
    assert captured.out == ""
    assert sorted(os.listdir(tmp_path)) == before


def test_main_lists_the_eleven_apps_in_the_jax_order(capsys):
    from opencv_opencl_tpu import __main__ as jax_entry
    from opencv_opencl_tpu_torch import __main__ as entry

    def apps(text):
        return re.findall(r"^  (\w+) +<- ", text, re.M)

    entry.main()
    ours = capsys.readouterr().out
    jax_entry.main()
    theirs = capsys.readouterr().out
    assert apps(ours)[:11] == apps(theirs)[:11]
    assert apps(ours)[:11] == [
        "histeq_image", "clahe_image", "m2_bench", "parity_bench", "clahe_video",
        "airplan_mp4", "relay", "sender", "rtp_receiver", "multi_relay",
        "h26x_stream"]

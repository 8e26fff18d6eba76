"""The port's relay entry points against the JAX package's.

- The copied host modules are held to the originals: ``parse_kv_args`` on
  the cases of tests/test_apps.py, ``TestSource`` frame for frame for two
  seeds, ``RateGovernor`` / ``AdaptiveRateGovernor`` decision for decision
  on the cases of tests/test_governor.py with an injected clock,
  ``build_rtp_session_sdp`` string-equal, and an ``RtpUdpSink``
  ``rtp+raw://`` loopback whose datagrams equal the JAX package's sink's
  byte for byte.
- **The slice as a whole**: ``relay.run`` of both packages on the same
  ``TestSource`` (``--device=cpu`` in the port, where the wrappers run their
  plain versions), raw NV12 files compared: byte-equal for histeq; for the
  CLAHE paths within ``assert_clahe_close`` (at most 1 LSB on tie pixels:
  the JAX CPU backend FMA-contracts the blend, tests/conftest.py) while the
  port's file equals ``core/golden.py`` **exactly**.  Return codes, printed
  markers and refusal messages are the same.  ``--mesh=2x2`` and ``2x1``
  run as real gloo process groups (``run_on_mesh``), rank 0's file against
  the JAX relay's on its 8-device CPU mesh.
- ``StreamMux`` on the cases of tests/test_mux.py and ``multi_relay.run``.

Sockets stay on 127.0.0.1 with ports from the OS and short timeouts.
"""

import inspect
import re
import secrets
import socket

import cv2
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.apps import multi_relay as jax_multi_relay
from opencv_opencl_tpu.apps import relay as jax_relay
from opencv_opencl_tpu.apps._cli import parse_kv_args as jax_parse_kv_args
from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.core.frames import FrameSpec as JaxFrameSpec
from opencv_opencl_tpu.io import rtp as jax_rtp
from opencv_opencl_tpu.io import sdp as jax_sdp
from opencv_opencl_tpu.io import videofile as jax_videofile
from opencv_opencl_tpu.models import presets as jax_presets
from opencv_opencl_tpu.runtime import governor as jax_governor
from opencv_opencl_tpu_torch.apps import multi_relay, relay
from opencv_opencl_tpu_torch.apps._cli import get_arg, parse_kv_args
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.io import rtp, sdp, videofile
from opencv_opencl_tpu_torch.io.gst import EncoderConfig
from opencv_opencl_tpu_torch.models import presets
from opencv_opencl_tpu_torch.models.enhancer import (
    Enhancer, EnhancerConfig, initial_hists)
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops.cuda import natural
from opencv_opencl_tpu_torch.parallel import launch
from opencv_opencl_tpu_torch.runtime import governor
from opencv_opencl_tpu_torch.runtime.feeder import FrameFeeder
from opencv_opencl_tpu_torch.runtime.mux import StreamMux
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

SIZES = [(64, 48), (128, 96)]


# ------------------------------------------------------------ the copies ----


@pytest.mark.parametrize("argv,spec,want_opts,want_pos", [
    (["--codec=h265", "--bitrate", "5000", "file.mp4"],
     {"codec": str, "bitrate": int}, {"codec": "h265", "bitrate": 5000},
     ["file.mp4"]),
    (["--loop", "--udp-only=false"], {"loop": bool, "udp-only": bool},
     {"loop": True, "udp-only": False}, []),
    (["--nope=1"], {"input": str}, {}, []),
    (["--bitrate=abc"], {"bitrate": int}, {}, []),
])
def test_parse_kv_args_equals_jax(argv, spec, want_opts, want_pos, capsys):
    want = jax_parse_kv_args(list(argv), spec)
    want_err = capsys.readouterr().err
    got = parse_kv_args(list(argv), spec)
    got_err = capsys.readouterr().err
    assert got == want == (want_opts, want_pos)
    assert got_err == want_err
    if argv == ["--nope=1"]:
        assert "ignoring unknown arg" in got_err
    assert get_arg({"a": 1}, "a", 2) == 1 and get_arg({}, "a", 2) == 2


@pytest.mark.parametrize("seed", [0, 7])
def test_test_source_equals_jax_frame_for_frame(seed):
    ours = videofile.TestSource(FrameSpec(width=64, height=48), num_frames=5,
                                seed=seed)
    theirs = jax_videofile.TestSource(JaxFrameSpec(width=64, height=48),
                                      num_frames=5, seed=seed)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (72, 64)
        assert np.array_equal(g, w)
    assert ours.read() is None


def test_sinks_and_resample_fps_equal_jax(tmp_path):
    frames = list(videofile.TestSource(FrameSpec(width=32, height=16), 4))
    for mod, name in ((videofile, "a.nv12"), (jax_videofile, "b.nv12")):
        sink = mod.RawSink(str(tmp_path / name))
        for f in frames:
            sink.write(f)
        sink.close()
        assert sink.frames == 4
    assert (tmp_path / "a.nv12").read_bytes() == (tmp_path / "b.nv12").read_bytes()
    null = videofile.NullSink()
    null.write(frames[0])
    null.close()
    assert null.frames == 1
    for src, dst in ((30.0, 60.0), (60.0, 24.0), (30.0, 30.0), (0.0, 30.0)):
        assert (list(videofile.resample_fps(range(12), src, dst))
                == list(jax_videofile.resample_fps(range(12), src, dst)))


def _admissions(mod, times, **kw):
    t = [0.0]
    gov = mod.RateGovernor(clock=lambda: t[0], **kw)
    out = []
    for now in times:
        t[0] = now
        out.append(gov.admit())
    return out, gov.dropped


@pytest.mark.parametrize("times,rate", [
    ([i / 60.0 for i in range(120)], 30),      # caps 60 fps input
    ([i / 10.0 for i in range(30)], 30),       # slow input passes through
    ([0.0, 10.0, 10.01], 30),                  # resync after a gap
])
def test_rate_governor_equals_jax(times, rate):
    got = _admissions(governor, times, max_rate=rate)
    want = _admissions(jax_governor, times, max_rate=rate)
    assert got == want
    if len(times) == 120:
        assert 58 <= sum(got[0]) <= 61
    if len(times) == 3:
        assert got[0] == [True, True, False]
    with pytest.raises(ValueError):
        governor.RateGovernor(0)


def test_adaptive_governor_equals_jax():
    reports = [26, 26] + [0] * 100 + [255] * 100 + [2, 128]
    rates = []
    for mod in (governor, jax_governor):
        t = [0.0]
        gov = mod.AdaptiveRateGovernor(max_rate=60, min_rate=5, clock=lambda: t[0])
        seen = [gov.on_receiver_report(r) for r in reports]
        admitted = []
        for i in range(240):
            t[0] = i / 120.0
            admitted.append(gov.admit())
        rates.append((seen, admitted, gov.backoffs))
    assert rates[0] == rates[1]
    assert rates[0][0][0] == pytest.approx(60 * 0.7)
    assert 5 in rates[0][0] and 60 in rates[0][0]
    with pytest.raises(ValueError):
        governor.AdaptiveRateGovernor(60, backoff=1.5)
    with pytest.raises(ValueError):
        governor.AdaptiveRateGovernor(60, recover=0.5)


def test_feed_governor_from_rtcp_backs_off_once_per_drain():
    from opencv_opencl_tpu_torch.io.rtcp import ReportBlock

    class FakeRtcp:
        def __init__(self, blocks):
            self._blocks = blocks

        def poll(self):
            pass

        def take_blocks(self):
            b, self._blocks = self._blocks, []
            return b

    class FakeSink:
        def __init__(self, blocks):
            self.rtcp = FakeRtcp(blocks)

    gov = governor.AdaptiveRateGovernor(30.0, backoff=0.7)
    blocks = [ReportBlock(1, 128, 0, 0, 0, 0, 0) for _ in range(4)]
    governor.feed_governor_from_rtcp(gov, FakeSink(blocks))
    assert gov.rate == pytest.approx(30.0 * 0.7) and gov.backoffs == 1
    governor.feed_governor_from_rtcp(gov, object())  # no .rtcp: a no-op
    assert gov.rate == pytest.approx(30.0 * 0.7)


@pytest.mark.parametrize("kind", ["raw", "jpeg", "h264", "h265"])
def test_rtp_session_sdp_string_equal(kind, monkeypatch):
    monkeypatch.setattr(secrets, "randbits", lambda bits: 424242)
    got = sdp.build_rtp_session_sdp("127.0.0.1", 5004, kind, width=128, height=96)
    want = jax_sdp.build_rtp_session_sdp("127.0.0.1", 5004, kind, width=128,
                                         height=96)
    assert got == want
    assert "m=video 5004" in got


def _catch_datagrams(send, timeout=2.0):
    """Run ``send(port)`` against a UDP socket on 127.0.0.1 and return the
    datagrams it received until the sender is done."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        sock.bind(("127.0.0.1", 0))
        sock.settimeout(timeout)
        expected = send(sock.getsockname()[1])
        return [sock.recvfrom(65536)[0] for _ in range(expected)]
    finally:
        sock.close()


def test_rtp_raw_sink_packets_equal_jax_byte_for_byte(monkeypatch):
    # the JAX sink packetizes in Python; the port's sends through its C++
    # packetizer where the native library builds: the same datagrams
    monkeypatch.setattr("opencv_opencl_tpu.native.available", lambda: False)
    frames = list(videofile.TestSource(FrameSpec(width=64, height=48), 3, seed=3))

    def sender(mod):
        def send(port):
            sink = mod.RtpUdpSink("127.0.0.1", port, kind="raw", fps=30.0,
                                  mtu=64, rtcp=False)
            for f in frames:
                sink.write(f)
            sink.close()
            assert sink.frames == 3 and sink.send_errors == 0
            return sink.packets
        return send

    got = _catch_datagrams(sender(rtp))
    want = _catch_datagrams(sender(jax_rtp))
    assert len(got) == len(want) > 3 * 72
    assert got == want
    # the reference's constructor: the sink chooses its packetizer itself
    assert (inspect.signature(rtp.RtpUdpSink)
            == inspect.signature(jax_rtp.RtpUdpSink))
    with pytest.raises(ValueError):
        rtp.RtpUdpSink("127.0.0.1", 9, kind="h264")


def test_rtp_raw_loopback_reassembles_the_frames():
    frames = list(videofile.TestSource(FrameSpec(width=64, height=48), 3, seed=4))
    rx = rtp.RtpUdpReceiver(port=0, kind="raw", frame_shape=(72, 64),
                            timeout=2.0, rtcp=False)
    sink = rtp.RtpUdpSink("127.0.0.1", rx.port, kind="raw", fps=30.0, rtcp=False)
    try:
        for f in frames:
            sink.write(f)
            assert np.array_equal(rx.recv_frame(), f)
    finally:
        sink.close()
        rx.close()
    assert rx.frames_dropped == 0 and rx.packets_bad == 0


def test_presets_equal_jax_and_build_on_the_cpu():
    assert list(presets.PRESETS) == list(jax_presets.PRESETS)
    for name, want in jax_presets.PRESETS.items():
        got = presets.PRESETS[name]
        for field in ("reference", "description", "width", "height", "fps",
                      "tuned_emit"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        for field in ("op", "clip_limit", "tile_grid", "use_ref_frame",
                      "hist_downsample"):
            assert getattr(got.enhancer, field) == getattr(want.enhancer, field)
        assert got.enhancer.chroma.value == want.enhancer.chroma.value
        assert (got.encoder.codec, got.encoder.bitrate_kbps) == (
            want.encoder.codec, want.encoder.bitrate_kbps)
    enhancer, spec, enc = presets.build("clahecompare", device="cpu")
    assert isinstance(enhancer, Enhancer) and isinstance(enc, EncoderConfig)
    assert (spec.width, spec.height, spec.fps) == (1280, 720, 30)
    assert enhancer.device.type == "cpu" and enhancer.cfg.op == "clahe"


def test_main_lists_the_ported_apps_and_presets(capsys):
    from opencv_opencl_tpu_torch import __main__ as entry

    entry.main()
    out = capsys.readouterr().out
    assert "opencv_opencl_tpu_torch environment" in out
    assert "relay" in out and "multi_relay" in out
    for name in presets.PRESETS:
        assert name in out


# ------------------------------------------------- the slice as a whole ----


BASE = ["--source=test", "--fps=30", "--max-frames=8", "--batch=2",
        "--workers=2", "--status-interval=60"]

CONFIGS = {
    "histeq_gray": ["--op=histeq", "--chroma=gray"],
    "clahe_passthrough": ["--op=clahe", "--chroma=passthrough"],
    "clahe_ref_frame": ["--op=clahe", "--chroma=passthrough", "--ref-frame"],
    "clahe_hist_downsample": ["--op=clahe", "--chroma=passthrough",
                              "--hist-downsample=2"],
    "preset_histequalize": ["--preset=histequalize"],
}


def _size(w, h):
    return [f"--width={w}", f"--height={h}"]


def _frames_of(path, w, h):
    raw = np.fromfile(str(path), np.uint8)
    rows = h * 3 // 2
    assert raw.size % (rows * w) == 0
    return raw.reshape(-1, rows, w)


def _golden_outputs(name, src, w, h):
    """What ``core/golden.py`` (cv2 for histeq) gives for the configuration,
    or None where golden has no such mode."""
    y = src[:, :h]
    if name in ("histeq_gray", "preset_histequalize"):
        out_y = np.stack([cv2.equalizeHist(f) for f in y])
        uv = np.full_like(src[:, h:], 128)
    elif name == "clahe_passthrough":
        out_y = np.stack([golden.clahe(f, 2.0, (8, 8)) for f in y])
        uv = src[:, h:]
    elif name == "clahe_ref_frame":
        plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
        start = natural.build_luts_ref(initial_hists(plan, "cpu")[None], plan.clip,
                                       plan.lut_scale)[0].numpy()
        outs = []
        for i, f in enumerate(y):
            if i == 0:
                luts = start.reshape(plan.tiles_y, plan.tiles_x, 256)
                th, tw = plan.tile_h, plan.tile_w
            else:
                luts, th, tw = golden.clahe_luts(y[i - 1], 2.0, (8, 8))
            outs.append(golden.clahe_apply_luts(f, luts, th, tw))
        out_y, uv = np.stack(outs), src[:, h:]
    else:
        return None
    return np.concatenate([out_y, uv], axis=1)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_relay_raw_output_equals_jax_relay(name, w, h, tmp_path, capsys):
    ours, theirs = tmp_path / "port.nv12", tmp_path / "jax.nv12"
    args = BASE + CONFIGS[name] + _size(w, h)
    rc = relay.run(args + ["--device=cpu", f"--sink={ours}"])
    got_out = capsys.readouterr().out
    jax_rc = jax_relay.run(args + [f"--sink={theirs}"])
    want_out = capsys.readouterr().out
    assert rc == jax_rc == 0
    for marker in ("relay pipeline started", "(with frame ordering)",
                   "8 frames emitted", "errors=0", "FINAL PERFORMANCE ANALYSIS"):
        assert marker in got_out and marker in want_out, marker
    for text in ("Preset 'histequalize'", "APPROXIMATE histogram mode"):
        assert (text in got_out) == (text in want_out)
    got, want = _frames_of(ours, w, h), _frames_of(theirs, w, h)
    assert got.shape == want.shape == (8, h * 3 // 2, w)
    src = np.stack(list(videofile.TestSource(FrameSpec(width=w, height=h), 8)))
    if "histeq" in name:
        assert np.array_equal(got, want)                 # byte for byte
    else:
        assert_clahe_close(got[:, :h], want[:, :h])      # FMA ties in JAX
        assert np.array_equal(got[:, h:], want[:, h:])
    exact = _golden_outputs(name, src, w, h)
    if exact is not None:
        assert np.array_equal(got, exact)                # 0 LSB
    else:
        assert np.array_equal(got[:, h:], src[:, h:])


def test_relay_ref_frame_streaming_twelve_frames(capsys):
    """tests/test_apps.py's streaming case: the state carries over batches."""
    rc = relay.run(["--device=cpu", "--source=test", "--width=128", "--height=96",
                    "--max-frames=12", "--batch=4", "--op=clahe", "--ref-frame",
                    "--chroma=passthrough", "--status-interval=60"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "relay pipeline started" in out and "errors=0" in out


REFUSALS = [
    ("downsample_x_mesh", ["--sink=null", "--hist-downsample=2", "--mesh=2x1"],
     "not supported"),
    ("downsample_x_ref", ["--sink=null", "--op=clahe", "--hist-downsample=2",
                          "--ref-frame"], "not supported"),
    ("mesh_no_x", ["--mesh=8"], "invalid"),
    ("mesh_letters", ["--mesh=axb"], "invalid"),
    ("mesh_zero_axis", ["--mesh=0x2"], "axes must be >= 1"),
    ("mesh_too_large", ["--mesh=4x4"], "requested 16 devices"),
    ("rtcp_schedule", ["--sink=rtp://127.0.0.1:59000", "--rtcp-schedule=cron"],
     "tick|rfc3550"),
    ("max_rate", ["--max-rate=0"], "--max-rate must be > 0"),
    ("batch_x_mesh_data_axis", ["--mesh=1x1", "--batch=0"],
     "positive multiple of the mesh data axis"),
]


@pytest.mark.parametrize("name,extra,msg", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_relay_refusals_equal_jax(name, extra, msg, capsys):
    args = ["--source=test", "--width=64", "--height=32", "--max-frames=2",
            "--status-interval=60"] + extra
    rc = relay.run(args + ["--device=cpu"])
    got = capsys.readouterr().err
    jax_rc = jax_relay.run(args)
    want = capsys.readouterr().err
    assert rc == jax_rc == 2
    assert msg in got and msg in want
    if name == "mesh_too_large":        # "have 1" process, "have 8" devices
        got, want = got.replace("have 1", "have"), want.replace("have 8", "have")
    assert got == want


def _printed_lines(text):
    """The non-blank lines of an app's output with every number replaced,
    runs of spaces as one, and the port's "card" for the JAX package's
    "chip"."""
    return [" ".join(re.sub(r"-?\d+(\.\d+)?", "#", line).split())
            .replace(" card ", " chip ")
            for line in text.splitlines() if line.strip()]


# what each app needs to run to an end on the CPU in a moment
_RUN_ARGS = {relay: ["--source=test", "--max-frames=4", "--sink=null",
                     "--status-interval=60"],
             multi_relay: ["--streams=2", "--max-frames=4", "--batch=2",
                           "--fps=200", "--status-interval=60"]}


@pytest.mark.parametrize("extra", [
    ["--sink=rtp+h264://127.0.0.1:56470"],
    ["--sink=rtp+h265://127.0.0.1:56470", "--encoder=cavlc:qp=40"],
    ["--encoder=tpu:qp=40"],
    ["--sink=null", "--fused-encode"],
    ["--io=gst"],
    ["--native"],
], ids=["h264_sink", "h265_sink", "encoder", "fused_encode", "io_gst", "native"])
@pytest.mark.parametrize("app", [relay, multi_relay], ids=["relay", "multi_relay"])
def test_unported_flags_refuse_with_not_ported_yet(app, extra, capsys):
    """The encoded sinks and the flags of parts not ported refuse with rc 2
    and one line.  ``--encoder`` is read only for an rtp+h264:// or
    rtp+h265:// sink, as in the JAX package: with any other sink both
    packages run and print the same lines (the relay's first line says how
    the device program is made, which differs).  ``--native`` is ported:
    both packages run it and print the same lines, the relay's staging word
    included."""
    args = ["--width=64", "--height=32"]
    if extra in (["--encoder=tpu:qp=40"], ["--native"]):
        args += extra + _RUN_ARGS[app]
        rc = app.run(args + ["--device=cpu"])
        got = capsys.readouterr()
        jax_app = {relay: jax_relay, multi_relay: jax_multi_relay}[app]
        jax_rc = jax_app.run(args)
        want = capsys.readouterr()
        assert rc == jax_rc == 0
        assert got.err == want.err == ""
        skip = 1 if app is relay else 0
        assert _printed_lines(got.out)[skip:] == _printed_lines(want.out)[skip:]
        assert "Encoder:" not in got.out
        return
    if app is multi_relay and extra[-1] in ("--fused-encode", "--io=gst"):
        extra = ["--sink=rtp+h264://127.0.0.1:56470"]   # flags relay alone has
    rc = app.run(args + ["--device=cpu"] + extra)
    err = capsys.readouterr().err
    assert rc == 2
    assert "not ported yet" in err and len(err.strip().splitlines()) == 1


def test_relay_without_a_card_fails_and_does_not_fall_back(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for app in (relay, multi_relay):
        rc = app.run(["--source=test", "--width=64", "--height=32",
                      "--max-frames=2", "--sink=null"])
        captured = capsys.readouterr()
        assert rc not in (0, 2)
        assert "no CUDA device" in captured.err
        assert "frames emitted" not in captured.out
        assert "Serving" not in captured.out


def test_relay_mesh_1x1_starts_its_own_group_and_ends_it(tmp_path, capsys):
    import torch.distributed as dist

    path = tmp_path / "mesh.nv12"
    args = BASE + CONFIGS["clahe_passthrough"] + _size(64, 48)
    assert not dist.is_initialized()
    rc = relay.run(args + ["--device=cpu", "--mesh=1x1", f"--sink={path}"])
    out = capsys.readouterr().out
    assert rc == 0 and not dist.is_initialized()
    assert "Sharded over mesh {'data': 1, 'space': 1} (1 devices)" in out
    src = np.stack(list(videofile.TestSource(FrameSpec(width=64, height=48), 8)))
    assert np.array_equal(_frames_of(path, 64, 48),
                          _golden_outputs("clahe_passthrough", src, 64, 48))
    rc = relay.run(args + ["--device=cpu", "--mesh=auto", "--sink=null"])
    assert rc == 0 and not dist.is_initialized()
    assert "8 frames emitted" in capsys.readouterr().out


@pytest.mark.parametrize("mesh,name", [("2x2", "clahe_passthrough"),
                                       ("2x1", "histeq_gray")])
def test_relay_on_a_gloo_mesh_equals_jax_relay_on_its_cpu_mesh(mesh, name, tmp_path,
                                                               capsys):
    w, h = 64, 48
    ours, theirs = tmp_path / "port.nv12", tmp_path / "jax.nv12"
    args = BASE + CONFIGS[name] + _size(w, h) + [f"--mesh={mesh}"]
    shape = tuple(int(x) for x in mesh.split("x"))
    rcs = launch.run_on_mesh(shape, launch.run_relay,
                             (args + ["--device=cpu", f"--sink={ours}"],),
                             device_type="cpu", timeout=110.0)
    assert rcs == [0] * (shape[0] * shape[1])
    assert jax_relay.run(args + [f"--sink={theirs}"]) == 0
    assert f"Sharded over mesh {{'data': {shape[0]}, 'space': {shape[1]}}}" in \
        capsys.readouterr().out
    got, want = _frames_of(ours, w, h), _frames_of(theirs, w, h)
    assert got.shape == want.shape == (8, h * 3 // 2, w)
    src = np.stack(list(videofile.TestSource(FrameSpec(width=w, height=h), 8)))
    if "histeq" in name:
        assert np.array_equal(got, want)
    else:
        assert_clahe_close(got[:, :h], want[:, :h])
        assert np.array_equal(got[:, h:], want[:, h:])
    assert np.array_equal(got, _golden_outputs(name, src, w, h))


def test_relay_in_a_group_refuses_the_time_driven_flags():
    rcs = launch.run_on_mesh(
        (2, 1), launch.run_relay,
        (["--source=test", "--width=64", "--height=32", "--max-frames=2",
          "--mesh=2x1", "--batch=2", "--device=cpu", "--duration=5"],),
        device_type="cpu", timeout=110.0)
    assert rcs == [2, 2]


def test_feeder_whole_batches_cut_by_count_not_by_timing():
    import time

    sizes = []

    def step(batch):
        sizes.append(len(batch))
        return np.asarray(batch).copy()

    got = []
    feeder = FrameFeeder(step, batch_size=4, depth=2, queue_capacity=16,
                         on_output=lambda seq, f, meta: got.append(meta),
                         pad_batches=False, whole_batches=True)
    feeder.start()
    for k in range(10):
        feeder.submit(np.full((6, 8), k, np.uint8), meta=k)
        time.sleep(0.06 if k in (1, 6) else 0.0)   # longer than the pop timeout
    feeder.stop(drain=True, timeout=30)
    assert sizes == [4, 4, 2]
    assert got == list(range(10))


# ---------------------------------------------------- mux, multi_relay ----


MUX_SPEC = FrameSpec(width=64, height=48, fps=30)


def _mk_mux(n_streams, batch_size=4, **kw):
    enh = Enhancer(EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH),
                   MUX_SPEC, device="cpu")
    got = {s: [] for s in range(n_streams)}

    def on_out(stream, sseq, frame, meta):
        got[stream].append((sseq, frame, meta))

    kw.setdefault("queue_capacity", 64)  # deterministic tests: no drops
    mux = StreamMux(enh.process_batch, n_streams, on_output=on_out,
                    batch_size=batch_size, **kw)
    return mux, got


def test_mux_routing_and_per_stream_order():
    rng = np.random.default_rng(50)
    n, per = 3, 5
    mux, got = _mk_mux(n)
    frames = rng.integers(0, 256, (n, per, MUX_SPEC.buffer_rows, MUX_SPEC.width),
                          dtype=np.uint8)
    mux.start()
    for k in range(per):
        for s in range(n):
            assert mux.submit(s, frames[s, k], meta={"k": k}) == k
    mux.stop(drain=True)
    for s in range(n):
        assert [k for k, _, _ in got[s]] == list(range(per))
        for k, out, meta in got[s]:
            assert meta == {"k": k}
            assert np.array_equal(out[:48], cv2.equalizeHist(frames[s, k, :48]))
            assert np.array_equal(out[48:], frames[s, k, 48:])
    stats = mux.stats
    assert stats["emitted"] == n * per
    assert all(p["submitted"] == per and p["emitted"] == per and p["dropped"] == 0
               for p in stats["per_stream"])


def test_mux_unbalanced_streams():
    rng = np.random.default_rng(51)
    mux, got = _mk_mux(2, batch_size=3)
    f = rng.integers(0, 256, (MUX_SPEC.buffer_rows, MUX_SPEC.width), dtype=np.uint8)
    mux.start()
    for k in range(7):
        mux.submit(0, f)
        if k % 3 == 0:
            mux.submit(1, f)
    mux.stop(drain=True)
    assert len(got[0]) == 7 and len(got[1]) == 3
    assert [k for k, _, _ in got[1]] == [0, 1, 2]


def test_mux_overload_stays_per_stream_ordered():
    rng = np.random.default_rng(52)
    mux, got = _mk_mux(2, batch_size=1, depth=1, queue_capacity=2)
    f = rng.integers(0, 256, (MUX_SPEC.buffer_rows, MUX_SPEC.width), dtype=np.uint8)
    mux.start()
    for k in range(40):
        mux.submit(k % 2, f)
    mux.stop(drain=True)
    for s in (0, 1):
        seqs = [k for k, _, _ in got[s]]
        assert seqs == sorted(seqs) and len(seqs) >= 1
    stats = mux.stats
    assert len(got[0]) + len(got[1]) <= 40
    assert (sum(p["dropped"] for p in stats["per_stream"])
            == stats["dropped_overflow"] == 40 - stats["emitted"])


def test_mux_priorities_and_bad_arguments():
    mux, _ = _mk_mux(2)
    f = np.zeros((MUX_SPEC.buffer_rows, MUX_SPEC.width), np.uint8)
    with pytest.raises(ValueError):
        mux.submit(2, f)
    with pytest.raises(ValueError):
        StreamMux(lambda x: x, 0)
    with pytest.raises(ValueError):
        StreamMux(lambda x: x, 2, priorities=[1])
    with pytest.raises(ValueError):
        StreamMux(lambda x: x, 2, native_staging=True)


def _shutdown_counts(text):
    m = re.search(r"Shutdown: (\d+) frames across (\d+) streams", text)
    assert m, text
    per = re.findall(r"#(\d+)=(\d+)/(\d+)", text)
    return int(m.group(1)), int(m.group(2)), [(int(e), int(s)) for _, e, s in per]


def test_multi_relay_two_streams_like_jax(capsys):
    args = ["--streams=2", "--width=96", "--height=64", "--op=histeq", "--batch=2",
            "--max-frames=6", "--fps=200", "--status-interval=0.05"]
    rc = multi_relay.run(args + ["--device=cpu"])
    got = capsys.readouterr().out
    jax_rc = jax_multi_relay.run(args)
    want = capsys.readouterr().out
    assert rc == jax_rc == 0
    assert "Serving 2 streams of 96x64 histeq" in got
    assert "Serving 2 streams" in want
    total, streams, per = _shutdown_counts(got)
    assert streams == 2 and total > 0
    assert [s for _, s in per] == [6, 6]            # 6 rounds, each stream
    assert total == sum(e for e, _ in per)
    assert _shutdown_counts(want)[1] == 2


def test_multi_relay_rtp_raw_streams_at_port_stride_two(capsys):
    """Stream i goes to port + 2*i; each receiver reassembles its own
    stream's first frame, which is the enhanced TestSource frame."""
    w, h, n = 64, 48, 2
    probe = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(8)]
    try:
        for s in probe:
            s.bind(("127.0.0.1", 0))
        ports = sorted(s.getsockname()[1] for s in probe)
    finally:
        for s in probe:
            s.close()
    base = next((p for p in ports if p % 2 == 0), ports[0])
    rxs = [rtp.RtpUdpReceiver(port=base + 2 * i, kind="raw",
                              frame_shape=(h * 3 // 2, w), timeout=5.0, rtcp=False)
           for i in range(n)]
    try:
        rc = multi_relay.run([
            f"--streams={n}", f"--width={w}", f"--height={h}", "--op=histeq",
            "--chroma=gray", "--batch=2", "--max-frames=3", "--fps=100",
            f"--sink=rtp+raw://127.0.0.1:{base}", "--device=cpu",
            "--status-interval=60"])
        out = capsys.readouterr().out
        assert rc == 0
        assert f"Sinks: rtp+raw://127.0.0.1:{base}..{base + 2}" in out
        first = next(iter(videofile.TestSource(FrameSpec(width=w, height=h))))
        want = np.concatenate([cv2.equalizeHist(first[:h]),
                               np.full((h // 2, w), 128, np.uint8)])
        for rx in rxs:
            assert np.array_equal(rx.recv_frame(), want)
    finally:
        for rx in rxs:
            rx.close()


def test_multi_relay_mesh_1x1_and_refusals(capsys):
    rc = multi_relay.run(["--streams=2", "--width=128", "--height=64", "--fps=200",
                          "--max-frames=6", "--batch=2", "--op=clahe",
                          "--mesh=1x1", "--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Sharded over mesh" in out
    assert _shutdown_counts(out)[0] > 0
    for extra, msg in ((["--mesh=2x2"], "requested 4 devices"),
                       (["--mesh=2"], "invalid"),
                       (["--hist-downsample=2", "--mesh=1x1"], "not supported"),
                       (["--priorities=1"], "needs 2 entries"),
                       (["--priorities=a,b"], "comma-separated ints"),
                       (["--max-rate=-1"], "--max-rate must be > 0")):
        rc = multi_relay.run(["--streams=2", "--width=64", "--height=32",
                              "--device=cpu"] + extra)
        assert rc == 2, extra
        assert msg in capsys.readouterr().err

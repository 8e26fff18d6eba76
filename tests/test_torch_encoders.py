"""The port's encoded emit side against the JAX package's.

The port copies ``io/rtp_h26x.py`` (RFC 6184/7798 payloaders, the
depacketizer, the sink and the receiver), ``io/mp4.py``, ``io/encoder.py``
(``make_encoder`` but ``tpu``, ``EncodedRtpSink``, ``FfmpegEncoder``),
``io/gst_encoder.py``, ``io/gst_adapter.py`` and the apps
``h26x_stream`` and ``rtp_receiver``.  Each case gives both packages the
same seed-made input and asks for the same packets, datagrams, files,
lines or errors (tolerance 0): payloading at two MTUs with the sequence
wrapping, depacketizing a stream with losses, duplicates, reordering and
garbage, the datagrams a sink puts on loopback (with and without the C++
sender), the MP4 of a GOP stream, the encoded sink's datagrams, the
ffmpeg encoder over a stand-in process, the GStreamer encoder and the
appsink/appsrc bridge over ``tests/fake_gst.py``, and the two apps.

Sockets stay on 127.0.0.1 with ports from the OS and short timeouts.  The
relays with an encoded sink are in ``tests/test_torch_encoded_relay.py``.
"""

import os
import socket
import stat
import struct
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from opencv_opencl_tpu.apps import h26x_stream as jax_h26x_stream
from opencv_opencl_tpu.apps import rtp_receiver as jax_rtp_receiver
from opencv_opencl_tpu.io import encoder as jax_encoder
from opencv_opencl_tpu.io import gst as jax_gst
from opencv_opencl_tpu.io import gst_adapter as jax_gst_adapter
from opencv_opencl_tpu.io import gst_encoder as jax_gst_encoder
from opencv_opencl_tpu.io import mp4 as jax_mp4
from opencv_opencl_tpu.io import rtp_h26x as jax_rtp_h26x
from opencv_opencl_tpu.runtime import FrameFeeder as JaxFrameFeeder
from opencv_opencl_tpu_torch import native
from opencv_opencl_tpu_torch.apps import h26x_stream, rtp_receiver
from opencv_opencl_tpu_torch.io import (
    encoder, gst, gst_adapter, gst_encoder, mp4, rtp_h26x)
from opencv_opencl_tpu_torch.io.h264_pcm import PcmH264Encoder
from opencv_opencl_tpu_torch.runtime.feeder import FrameFeeder
from tests import fake_gst
from tests.test_torch_h264 import moving_frames, outcome

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def h264_nal(ntype, size, seed=0, nri=3):
    body = np.random.default_rng(seed).integers(1, 255, size - 1, np.uint8).tobytes()
    return bytes([(nri << 5) | ntype]) + body


def h265_nal(ntype, size, seed=0):
    hdr = struct.pack("!H", (ntype << 9) | 1)             # layer 0, tid 1
    body = np.random.default_rng(seed).integers(1, 255, size - 2, np.uint8).tobytes()
    return hdr + body


def annexb(*nals):
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def access_units(codec):
    """Parameter sets with a large picture (aggregation and fragments), and
    smaller pictures, one of them exactly the size of an MTU's payload."""
    if codec == "h264":
        return [annexb(h264_nal(7, 20), h264_nal(8, 10), h264_nal(5, 5000, 1)),
                annexb(h264_nal(1, 1187, 2)), annexb(h264_nal(1, 300, 3)),
                annexb(h264_nal(6, 12), h264_nal(1, 2500, 4))]
    return [annexb(h265_nal(32, 24), h265_nal(33, 40), h265_nal(34, 10),
                   h265_nal(19, 5000, 1)),
            annexb(h265_nal(1, 1186, 2)), annexb(h265_nal(1, 300, 3))]


PAYLOADERS = {"h264": "H264RtpPayloader", "h265": "H265RtpPayloader"}


def packets(mod, codec, mtu, aus):
    pay = getattr(mod, PAYLOADERS[codec])(mtu=mtu, fps=30.0)
    pay.seq = 65530                                   # wraps inside the run
    return [p for au in aus for p in pay.packetize(au)], pay.seq, pay.ts


# ------------------------------------------------------------ rtp_h26x ----


@pytest.mark.parametrize("mtu", [64, rtp_h26x.DEFAULT_MTU])
@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_payloaders_give_the_jax_packets(codec, mtu):
    aus = access_units(codec)
    got = packets(rtp_h26x, codec, mtu, aus)
    assert got == packets(jax_rtp_h26x, codec, mtu, aus)
    depay = rtp_h26x.H26xDepacketizer(codec)
    out = [au for p in got[0] if (au := depay.push(p)) is not None]
    assert out == aus


@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_depacketizer_equals_jax_under_loss_duplicates_reordering_and_garbage(codec):
    pkts = packets(rtp_h26x, codec, 200, access_units(codec) * 3)[0]
    rng = np.random.default_rng(61)
    stream = []
    for i, p in enumerate(pkts):
        r = rng.random()
        if r < 0.05:
            continue                                             # lost
        stream.append(p)
        if r > 0.95:
            stream.append(p)                                     # duplicate
        if 0.90 < r <= 0.95 and len(stream) > 2:
            stream[-1], stream[-2] = stream[-2], stream[-1]      # reordered
        if i % 17 == 0:
            stream.append(rng.integers(0, 256, int(rng.integers(1, 40)),
                                       np.uint8).tobytes())      # garbage
    runs = []
    for mod in (rtp_h26x, jax_rtp_h26x):
        d = mod.H26xDepacketizer(codec)
        out = [outcome(lambda p=p: d.push(p)) for p in stream]
        runs.append((out, d.aus_dropped, d.packets_bad, d.packets_dup))
    assert runs[0] == runs[1]
    assert runs[0][1] > 0 and any(isinstance(a, bytes) for a in runs[0][0])


def test_annexb_and_access_unit_splitters_equal_jax():
    rng = np.random.default_rng(71)
    sl = [bytes([(3 << 5) | 1, 0x88 if first else 0x08])
          + rng.integers(1, 255, 30, np.uint8).tobytes() for first in (1, 0, 1, 1)]
    aud, eos = bytes([9, 0x10]), bytes([10])
    streams = [annexb(h264_nal(7, 10), h264_nal(8, 6), *sl),
               b"\x00\x00\x01" + aud + b"\x00\x00\x00\x01" + sl[0] + annexb(aud, sl[2], eos),
               b"", b"\x00\x00", b"garbage without a start code",
               annexb(h265_nal(32, 20), h265_nal(19, 100, 2), h265_nal(1, 50, 3))]
    for data in streams:
        assert rtp_h26x.split_annexb(data) == jax_rtp_h26x.split_annexb(data)
        for codec in ("h264", "h265"):
            assert (rtp_h26x.split_access_units(data, codec)
                    == jax_rtp_h26x.split_access_units(data, codec))
        assert outcome(lambda: mp4.split_nals(data)) == \
            outcome(lambda: jax_mp4.split_nals(data))
    assert h26x_stream.split_access_units is rtp_h26x.split_access_units


def _catch(send):
    """The datagrams that ``send(port)`` puts on a UDP socket bound on
    127.0.0.1, in the order they arrive."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.2)
    try:
        send(rx.getsockname()[1])
        got = []
        while True:
            try:
                got.append(rx.recv(65536))
            except OSError:
                return got
    finally:
        rx.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_h26x_sink_puts_the_jax_datagrams_on_loopback(use_native, monkeypatch):
    aus = access_units("h264")
    monkeypatch.setattr(native, "available", lambda: use_native)
    got = {}
    for mod in (rtp_h26x, jax_rtp_h26x):
        def send(port, mod=mod):
            sink = mod.H26xRtpSink("127.0.0.1", port, codec="h264", fps=25.0,
                                   rtcp=False)
            for au in aus:
                sink.write(au)
            got[mod] = (sink.frames, sink.packets, sink.bytes, sink.payload_octets)
            sink.close()
        got[mod] = (_catch(send), got[mod])
    assert got[rtp_h26x] == got[jax_rtp_h26x]
    assert len(got[rtp_h26x][0]) == got[rtp_h26x][1][1] > len(aus)


def test_h26x_sink_to_receivers_of_both_packages_with_rtcp():
    aus = access_units("h264")
    for rx_mod in (rtp_h26x, jax_rtp_h26x):
        rx = rx_mod.H26xRtpReceiver(host="127.0.0.1", port=0, codec="h264",
                                    timeout=5.0)
        rx.rtcp.interval = 0.0
        sink = rtp_h26x.H26xRtpSink("127.0.0.1", rx.port, codec="h264", fps=30)
        sink.rtcp.interval = 0.0
        try:
            got = []
            for au in aus:
                sink.write(au)
                got.append(rx.recv_access_unit())
                time.sleep(0.02)
            assert got == aus
            sink.rtcp.poll()
            assert sink.rtcp.remote_blocks
            assert sink.rtcp.remote_blocks[-1].cumulative_lost == 0
        finally:
            sink.close()
            rx.close()


def test_receiver_relocks_onto_a_restarted_sender():
    rx = rtp_h26x.H26xRtpReceiver(host="127.0.0.1", codec="h264", timeout=5.0,
                                  relock_timeout=0.3)
    au1, au2 = annexb(h264_nal(5, 600, 1)), annexb(h264_nal(1, 600, 2))
    try:
        for ssrc, au in ((0x11110001, au1), (0x22220002, au2)):
            tx = rtp_h26x.H26xRtpSink("127.0.0.1", rx.port, codec="h264")
            tx.payloader.ssrc = ssrc
            tx.write(au)
            assert rx.recv_access_unit() == au
            tx.close()
            time.sleep(0.4)                           # silence > relock_timeout
    finally:
        rx.close()


@pytest.mark.parametrize("kw", [dict(codec="h264", mtu=13), dict(codec="vp8")])
def test_h26x_sink_refuses_as_jax(kw):
    got = outcome(lambda: rtp_h26x.H26xRtpSink("127.0.0.1", 9, **kw))
    assert got[0] == "ValueError"
    assert got == outcome(lambda: jax_rtp_h26x.H26xRtpSink("127.0.0.1", 9, **kw))


# ------------------------------------------------------------------ mp4 ----


def test_mp4_of_a_gop_stream_equals_jax(tmp_path):
    for w, h in ((64, 48), (40, 24)):
        enc = encoder.make_encoder("cavlc:qp=30:gop=3", w, h)
        aus = [au for f in moving_frames(w, h, 5) for au in enc.encode(f)]
        info = [m.write_mp4(str(tmp_path / f"{m.__name__}.mp4"), aus, fps=25.0)
                for m in (mp4, jax_mp4)]
        assert info[0] == info[1] and info[0]["samples"] == 5
        assert info[0]["width"] == w and info[0]["sync_samples"] == 2
        assert ((tmp_path / f"{mp4.__name__}.mp4").read_bytes()
                == (tmp_path / f"{jax_mp4.__name__}.mp4").read_bytes())
        sps = mp4.split_nals(aus[0])[0]
        assert mp4.parse_sps_dims(sps) == jax_mp4.parse_sps_dims(sps) == (w, h)
    bare = [annexb(h264_nal(5, 100))]
    assert outcome(lambda: mp4.write_mp4(str(tmp_path / "a.mp4"), bare, 30.0)) == \
        outcome(lambda: jax_mp4.write_mp4(str(tmp_path / "b.mp4"), bare, 30.0))


# -------------------------------------------------------------- encoder ----


def test_available_encoders_equal_jax():
    assert encoder.available_encoders() == jax_encoder.available_encoders()
    assert encoder.available_encoders()[-1] == "pcm"
    assert gst_adapter.gi_available() == jax_gst_adapter.gi_available()


@pytest.mark.parametrize("spec", ["pcm", "cavlc:qp=30", "cavlc:qp=30:gop=3:search=1"])
def test_encoded_rtp_sink_puts_the_jax_datagrams_on_loopback(spec):
    frames = moving_frames(64, 48, 4, seed=3)
    got = {}
    for mod in (encoder, jax_encoder):
        tapped = []

        def send(port, mod=mod, tapped=tapped):
            sink = mod.encoded_rtp_sink_from_url(
                f"rtp+h264://127.0.0.1:{port - 4}", 64, 48, fps=30.0,
                backend=spec, port_offset=4)
            sink.au_tap = tapped.append
            for f in frames:
                sink.write(f)
            sink.close()
            got[mod] = (type(sink.encoder).__name__, sink.aus_sent,
                        sink.rtp.addr[1] - port)
        got[mod] = (_catch(send), tapped, got[mod])
    assert got[encoder] == got[jax_encoder]
    assert got[encoder][2][1:] == (4, 0) and len(got[encoder][1]) == 4


@pytest.mark.parametrize("url,kw", [
    ("rtp+h264://127.0.0.1:5000", dict(rtcp_schedule="cron")),
    ("rtp+vp8://127.0.0.1:5000", {}),
    ("rtp+h264://127.0.0.1", {}),
    ("rtp+h264://127.0.0.1:port", {}),
    ("rtp+h264://127.0.0.1:5000", dict(backend="nope")),
    ("rtp+h265://127.0.0.1:5000", dict(backend="cavlc")),
])
def test_encoded_rtp_sink_from_url_refuses_as_jax(url, kw):
    got = outcome(lambda: encoder.encoded_rtp_sink_from_url(url, 64, 48, **kw))
    assert got[0] == "ValueError"
    assert got == outcome(lambda: jax_encoder.encoded_rtp_sink_from_url(url, 64, 48, **kw))


def _stub(tmp_path, body):
    """An executable stand-in for ``ffmpeg`` running ``body`` (Python) with
    the repository on its path."""
    path = tmp_path / "ffmpeg"
    path.write_text(f"#!{sys.executable}\nimport sys\nsys.path.insert(0, {ROOT!r})\n"
                    + textwrap.dedent(body))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_ffmpeg_encoder_over_a_stand_in_process_equals_jax(tmp_path):
    """The stand-in PCM-encodes each raw NV12 frame it reads (no ffmpeg
    here): both packages' ``FfmpegEncoder`` frame its output into the same
    access units, those of ``PcmH264Encoder``."""
    w, h = 64, 48
    stub = _stub(tmp_path, f"""\
        import numpy as np
        from opencv_opencl_tpu_torch.io.h264_pcm import PcmH264Encoder
        enc = PcmH264Encoder({w}, {h}, native="never")
        while True:
            buf = sys.stdin.buffer.read({w * h * 3 // 2})
            if len(buf) < {w * h * 3 // 2}:
                break
            for au in enc.encode(np.frombuffer(buf, np.uint8).reshape({h * 3 // 2}, {w})):
                sys.stdout.buffer.write(au)
        sys.stdout.buffer.flush()
        """)
    frames = moving_frames(w, h, 3, seed=8)
    ref = PcmH264Encoder(w, h)
    want = [au for f in frames for au in ref.encode(f)]
    for mod in (encoder, jax_encoder):
        enc = mod.FfmpegEncoder(w, h, fps=30.0, ffmpeg=stub)
        got = [au for f in frames for au in enc.encode(f)] + enc.flush()
        enc.close()
        assert got == want and enc.frames == 3


def test_ffmpeg_encoder_frames_three_byte_start_codes_as_jax(tmp_path):
    w, h = 32, 32
    stub = _stub(tmp_path, f"""\
        i = 0
        while len(sys.stdin.buffer.read({w * h * 3 // 2})) == {w * h * 3 // 2}:
            out = sys.stdout.buffer
            out.write(b"\\x00\\x00\\x01" + bytes([0x67, 66, 0xC0, 10, (i & 0xFF) | 1]))
            out.write(b"\\x00\\x00\\x01" + bytes([0x68, 0xCE, 0x38, 0x80]))
            out.write(b"\\x00\\x00\\x00\\x01" + bytes([0x65, 0x88])
                      + bytes((j * 7 + i) % 255 + 1 for j in range(40)))
            out.flush()
            i += 1
        """)
    frame = np.zeros((h * 3 // 2, w), np.uint8)
    runs = []
    for mod in (encoder, jax_encoder):
        enc = mod.FfmpegEncoder(w, h, ffmpeg=stub)
        got = []
        for _ in range(3):
            got.extend(enc.encode(frame))
            time.sleep(0.1)                  # the reader thread drains the stub
        got.extend(enc.flush())
        enc.close()
        runs.append(got)
    assert runs[0] == runs[1] and len(runs[0]) == 3
    assert [n[0] & 0x1F for n in rtp_h26x.split_annexb(runs[0][2])] == [7, 8, 5]


def test_ffmpeg_backend_without_ffmpeg_refuses_as_jax(monkeypatch):
    for mod in (encoder, jax_encoder):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    got = outcome(lambda: encoder.make_encoder("ffmpeg", 64, 48))
    assert got == outcome(lambda: jax_encoder.make_encoder("ffmpeg", 64, 48))
    assert "ffmpeg not on PATH" in got[1]
    assert encoder.available_encoders() == jax_encoder.available_encoders() == ["pcm"]


# ------------------------------------------------- GStreamer (fake_gst) ----


class _FakeEncSink:
    """An appsink that hands out queued samples, as an encoder would."""

    def __init__(self):
        self.queue, self.eos = [], False

    def emit(self, signal, *args):
        return self.queue.pop(0) if self.queue else None

    def get_property(self, name):
        return self.eos


def _gi_encoder_run(mod):
    gst_mod = fake_gst.FakeGst()
    gst_mod.Buffer, gst_mod.MapFlags = fake_gst.Buffer, fake_gst.MapFlags
    enc = mod.GiPipelineEncoder(96, 64, fps=30.0, gst=gst_mod, use_omx=False)
    src, pipe = enc.src, gst_mod.pipelines[0]
    enc.sink = _FakeEncSink()
    f = np.zeros((96, 96), np.uint8)
    out = [enc.encode(f)]
    enc.sink.queue = [fake_gst.Sample(fake_gst.Buffer(b"AU-1"), fake_gst.Caps()),
                      fake_gst.Sample(fake_gst.Buffer(b"AU-2"), fake_gst.Caps())]
    out.append(enc.encode(f))
    enc.sink.queue = [fake_gst.Sample(fake_gst.Buffer(b"AU-3"), fake_gst.Caps())]
    enc.sink.eos = True
    out.append(enc.flush())
    enc.close()
    return (out, enc.desc, [(b.pts, b.duration, bytes(b.data)) for b in src.pushed],
            src.eos_sent, pipe.state)


def test_gi_encoder_over_fake_gst_equals_jax():
    for args in ((96, 64, 30.0, "h264", 2000, False), (96, 64, 30.0, "h264", 2000, True),
                 (1920, 1080, 60.0, "h265", 8000, False)):
        assert (gst_encoder.encoder_pipeline_desc(*args[:5], use_omx=args[5])
                == jax_gst_encoder.encoder_pipeline_desc(*args[:5], use_omx=args[5]))
    got = _gi_encoder_run(gst_encoder)
    assert got == _gi_encoder_run(jax_gst_encoder)
    assert got[0] == [[], [b"AU-1", b"AU-2"], [b"AU-3"]]
    assert got[3] and got[4] == fake_gst.State.NULL


def _bridge_run(gstb, adapter, feeder_cls, policy, loop, ending):
    w, h = 64, 48
    fake = fake_gst.FakeGst()
    feeder = feeder_cls(lambda b: b + 1, batch_size=2, depth=1)
    bridge = adapter.GstAppBridge(
        fake, capture_desc=gstb.capture_pipeline(width=w, height=h, fps=30),
        emit_desc=gstb.emit_pipeline(gstb.EncoderConfig(), width=w, height=h),
        feeder=feeder, frame_shape=(h * 3 // 2, w), fps=30.0,
        policy=adapter.TimestampPolicy[policy], loop=loop)
    bridge.start()
    feeder.start()
    rng = np.random.default_rng(81)
    for i in range(4):
        f = rng.integers(0, 250, (h * 3 // 2, w), np.uint8)
        bridge._appsink.deliver(fake_gst.make_sample(
            f.tobytes(), w, h, pts=1000 * i, dts=1000 * i + 1, duration=33))
    bridge._appsink.deliver(fake_gst.make_sample(b"\x00" * 10, w, h))   # short
    bridge.capture.get_bus().post(ending)
    feeder.stop(drain=True)
    return ([(bytes(b.data), b.pts, b.dts, b.duration) for b in bridge._appsrc.pushed],
            bridge._appsrc.eos_sent, bridge.capture.state, bridge.emit.state,
            bridge.capture.seeks, bridge._video_info, feeder.stats["emitted"])


@pytest.mark.parametrize("policy,loop,ending", [
    ("RELAY", False, fake_gst.MessageType.EOS), ("SYNTHESIZE", False,
                                                 fake_gst.MessageType.EOS),
    ("COPY", True, fake_gst.MessageType.EOS), ("RELAY", False,
                                               fake_gst.MessageType.ERROR)])
def test_gst_bridge_over_fake_gst_equals_jax(policy, loop, ending):
    got = _bridge_run(gst, gst_adapter, FrameFeeder, policy, loop, ending)
    want = _bridge_run(jax_gst, jax_gst_adapter, JaxFrameFeeder, policy, loop, ending)
    assert got == want
    assert len(got[0]) == 4


# ----------------------------------------------------------------- apps ----


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("argv", [[], ["--input=/nonexistent.h264"], ["--codec=avc"],
                                  ["--mtu=5"], ["--max-frames=0"]])
def test_h26x_stream_refuses_as_jax(argv, tmp_path, capsys):
    es = tmp_path / "x.h264"
    es.write_bytes(annexb(bytes([0x65, 0x88, 1, 2])))
    if argv and argv[0] != "--input=/nonexistent.h264":
        argv = [f"--input={es}"] + argv
    rc = h26x_stream.run(argv)
    got = capsys.readouterr()
    assert rc == jax_h26x_stream.run(argv) == 2
    assert got == capsys.readouterr()


def _receive(app, argv, port, send):
    """``app.run(argv + [--port])`` in a thread while ``send(port)`` sends."""
    result = []
    t = threading.Thread(target=lambda: result.append(app.run(
        argv + [f"--port={port}", "--host=127.0.0.1"])), daemon=True)
    t.start()
    time.sleep(0.3)
    send(port)
    t.join(timeout=20)
    assert not t.is_alive() and result == [0]


def test_h26x_stream_replays_to_rtp_receiver_and_the_recording_equals_jax(tmp_path,
                                                                           capsys):
    """``rtp_receiver`` records what ``h26x_stream`` replays, byte for byte,
    in both packages; the printed lines match but for the times."""
    aus = [annexb(h264_nal(7, 12), h264_nal(5, 1800, 1)),
           annexb(h264_nal(1, 1500, 2)), annexb(h264_nal(1, 1200, 3))]
    es = tmp_path / "es.h264"
    es.write_bytes(b"".join(aus))
    outs = []
    for stream_app, rx_app in ((h26x_stream, rtp_receiver),
                               (jax_h26x_stream, jax_rtp_receiver)):
        out = tmp_path / f"{rx_app.__name__}.h264"
        _receive(rx_app, ["--kind=h264", "--max-frames=3", "--timeout=15",
                          f"--output={out}"], _free_port(),
                 lambda port, app=stream_app: app.run(
                     [f"--input={es}", "--host=127.0.0.1", f"--port={port}",
                      "--fps=60"]))
        outs.append((out.read_bytes(), [line.split()[:2] for line in
                                        capsys.readouterr().out.splitlines()]))
    assert outs[0] == outs[1]
    assert outs[0][0] == b"".join(aus)


def test_rtp_receiver_muxes_the_jax_mp4(tmp_path, capsys):
    enc = encoder.make_encoder("cavlc:qp=30:gop=3", 64, 48)
    aus = [au for f in moving_frames(64, 48, 4) for au in enc.encode(f)]

    def send(port):
        sink = rtp_h26x.H26xRtpSink("127.0.0.1", port, codec="h264")
        for au in aus:
            sink.write(au)
            time.sleep(0.02)
        sink.close()

    files = []
    for app in (rtp_receiver, jax_rtp_receiver):
        out = tmp_path / f"{app.__name__}.mp4"
        _receive(app, ["--kind=h264", "--max-frames=4", "--timeout=15", "--fps=25",
                       f"--output={out}"], _free_port(), send)
        files.append(out.read_bytes())
        assert "MP4 saved to" in capsys.readouterr().out
    assert files[0] == files[1]
    assert files[0] == (mp4.write_mp4(str(tmp_path / "direct.mp4"), aus, 25.0)
                        and (tmp_path / "direct.mp4").read_bytes())


def test_rtp_receiver_raw_kind_needs_a_size_as_jax(capsys):
    argv = ["--kind=raw", "--port=9", "--timeout=0.1"]
    assert rtp_receiver.run(argv) == jax_rtp_receiver.run(argv) == 1
    err = capsys.readouterr().err
    assert err.count("--kind=raw needs --width and --height") == 2

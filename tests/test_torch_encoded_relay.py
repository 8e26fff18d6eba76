"""The port's relays with an encoded RTP sink against the JAX package's.

``relay`` and ``multi_relay`` of both packages run on the same
``TestSource`` frames (histeq, gray chroma: byte-equal in both packages;
the port on ``--device=cpu``) with ``--sink=rtp+h264://`` and the in-repo
encoders, and put the same datagrams on loopback, in the same order, with
the same ``Encoder:`` and ``Sinks:`` lines; the SDP file of an encoded sink
is the same; the refusals are the same, line for line.  The intra device
encoder (``--encoder=tpu:qp=40``) puts the JAX relays' datagrams on
loopback too (its ``Encoder:`` line names the port's class,
``CudaCavlcEncoder``, where the JAX package's names ``TpuCavlcEncoder``);
``tpu:qp=40:i4:chromah`` is held to the port's own oracle, the relay with
``cavlc:qp=40:slices=<mb rows>:i4:chromah``, so that JAX compiles no second
Intra_4x4 program here.  The GOP device encoder
(``--encoder=tpu:qp=40:gop=4:search=2``, ``CudaGopEncoder`` for
``TpuGopEncoder``) puts the JAX relays' datagrams on loopback from both
relays.  The rows of ``tests/test_flag_matrix.py`` run against the port's
relay: the GOP/GDR device encoder's run (``--encoder=tpu:gop=N``,
``tpu:gdr=N``), those of its partition modes and of the device bit packer
too, and so do those of ``--fused-encode`` (the fused enhance + encode
step), which print the JAX relay's "Fused enhance+encode" line, and with
``--mesh=2x1`` on a gloo group of two processes (``launch.run_relay``) its
"over mesh" line; its refusals are the JAX relay's, those of ``--mesh``
(``gdr``, ``cpb``, a ``--batch`` that is no multiple of the ranks times the
GOP) included.  The fused relay puts the JAX fused relay's
datagrams on loopback (``tpu:qp=40:i4:chromah``, whose ``i4`` and
``chromah`` the fused step does not read, and a GOP with a search), and
the port's ``rtp_receiver`` records the same access units from the fused
relay as from the unfused one; over a 2x1 gloo group
(``--mesh=2x1 --fused-encode``) it prints the JAX mesh relay's lines and
sends the single-card fused relay's datagrams.
"""

import contextlib
import re
import socket
import threading
import time

import pytest

from opencv_opencl_tpu.apps import multi_relay as jax_multi_relay
from opencv_opencl_tpu.apps import relay as jax_relay
from opencv_opencl_tpu.io import encoder as jax_encoder
from opencv_opencl_tpu_torch.apps import multi_relay, relay, rtp_receiver
from opencv_opencl_tpu_torch.io import encoder
from opencv_opencl_tpu_torch.parallel import launch

RELAY_BASE = ["--source=test", "--width=64", "--height=48", "--op=histeq",
              "--chroma=gray", "--batch=2", "--max-frames=6",
              "--status-interval=60"]
MULTI_BASE = ["--streams=2", "--width=64", "--height=48", "--op=histeq",
              "--chroma=gray", "--batch=2", "--max-frames=4", "--fps=200",
              "--status-interval=60"]


@contextlib.contextmanager
def catchers(n):
    """``n`` UDP sockets on 127.0.0.1 at ports ``p, p + 2, ...``."""
    for _ in range(50):
        socks = []
        try:
            first = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            socks.append(first)
            first.bind(("127.0.0.1", 0))
            base = first.getsockname()[1]
            for i in range(1, n):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(s)
                s.bind(("127.0.0.1", base + 2 * i))
        except OSError:
            for s in socks:
                s.close()
            continue
        for s in socks:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
            s.settimeout(0.2)
        try:
            yield base, socks
        finally:
            for s in socks:
                s.close()
        return
    raise RuntimeError("no free ports at a stride of 2")


def drain(sock):
    got = []
    while True:
        try:
            got.append(sock.recv(65536))
        except OSError:
            return got


def _lines(out, *prefixes):
    return [line for line in out.splitlines() if line.startswith(prefixes)]


ENCODERS = {"cavlc": "CavlcH264Encoder", "pcm": "PcmH264Encoder",
            "cavlc:qp=30:gop=3:search=1": "GopCavlcEncoder"}


@pytest.mark.parametrize("spec", list(ENCODERS))
def test_relay_streams_the_jax_datagrams(spec, capsys):
    runs = []
    with catchers(1) as (port, (sock,)):
        argv = RELAY_BASE + [f"--sink=rtp+h264://127.0.0.1:{port}", f"--encoder={spec}"]
        for app, extra in ((relay, ["--device=cpu"]), (jax_relay, [])):
            assert app.run(argv + extra) == 0
            out = capsys.readouterr().out
            assert "6 frames emitted" in out and "errors=0" in out
            runs.append((drain(sock), _lines(out, "Encoder:")))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) >= 6
    assert runs[0][1] == [f"Encoder: {ENCODERS[spec]} (h264)"]


# the intra device encoder: (spec, the relay run beside the port's, the
# oracle's spec); at 64x48 a frame has 3 MB rows
TPU_RELAYS = {"tpu:qp=40": (jax_relay, "tpu:qp=40"),
              "tpu:qp=40:i4:chromah": (relay, "cavlc:qp=40:slices=3:i4:chromah"),
              "tpu:qp=40:gop=4:search=2": (jax_relay, "tpu:qp=40:gop=4:search=2")}
# the Encoder: line's class, by package and by spec
TPU_CLASSES = {"gop=": ("CudaGopEncoder", "TpuGopEncoder"),
               "": ("CudaCavlcEncoder", "TpuCavlcEncoder")}


def _tpu_classes(spec):
    return next(v for k, v in TPU_CLASSES.items() if k in spec)


@pytest.mark.parametrize("spec", list(TPU_RELAYS))
def test_relay_tpu_streams_the_jax_datagrams(spec, capsys):
    """``--encoder=tpu...`` with ``--device=cpu`` (the kernels' plain
    versions) sends the datagrams of the JAX relay's ``TpuCavlcEncoder`` or
    ``TpuGopEncoder``, or of the port's host oracle; the ``Encoder:`` lines
    differ by the class name alone."""
    oracle_app, oracle_spec = TPU_RELAYS[spec]
    runs = []
    with catchers(1) as (port, (sock,)):
        argv = RELAY_BASE + [f"--sink=rtp+h264://127.0.0.1:{port}"]
        for app, extra in ((relay, [f"--encoder={spec}", "--device=cpu"]),
                           (oracle_app, [f"--encoder={oracle_spec}"]
                            + (["--device=cpu"] if oracle_app is relay else []))):
            assert app.run(argv + extra) == 0
            out = capsys.readouterr().out
            assert "6 frames emitted" in out and "errors=0" in out
            runs.append((drain(sock), _lines(out, "Encoder:")))
    port_class, jax_class = _tpu_classes(spec)
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) >= 6
    assert runs[0][1] == [f"Encoder: {port_class} (h264)"]
    assert runs[1][1] == [f"Encoder: {jax_class if oracle_app is jax_relay else 'CavlcH264Encoder'} (h264)"]


def test_multi_relay_tpu_streams_the_jax_datagrams_per_stream(capsys):
    runs = []
    with catchers(2) as (port, socks):
        argv = MULTI_BASE + [f"--sink=rtp+h264://127.0.0.1:{port}", "--encoder=tpu:qp=40"]
        for app, extra in ((multi_relay, ["--device=cpu"]), (jax_multi_relay, [])):
            assert app.run(argv + extra) == 0
            out = capsys.readouterr().out
            assert re.findall(r"#\d+=(\d+)/(\d+)", out) == [("4", "4")] * 2, out
            runs.append(([drain(s) for s in socks], _lines(out, "Sinks:")))
    assert runs[0][0] == runs[1][0] and all(len(d) >= 4 for d in runs[0][0])
    assert [line.replace("TpuCavlcEncoder", "CudaCavlcEncoder") for line in runs[1][1]] \
        == runs[0][1] == [f"Sinks: encoded RTP rtp+h264://127.0.0.1:{port} .. +2 "
                          f"(encoder=CudaCavlcEncoder)"]


def test_multi_relay_tpu_gop_streams_the_jax_datagrams_per_stream(capsys):
    """The GOP device encoder with a motion search, one per stream."""
    runs = []
    with catchers(2) as (port, socks):
        argv = MULTI_BASE + [f"--sink=rtp+h264://127.0.0.1:{port}",
                             "--encoder=tpu:qp=40:gop=4:search=2"]
        for app, extra in ((multi_relay, ["--device=cpu"]), (jax_multi_relay, [])):
            assert app.run(argv + extra) == 0
            out = capsys.readouterr().out
            assert re.findall(r"#\d+=(\d+)/(\d+)", out) == [("4", "4")] * 2, out
            runs.append(([drain(s) for s in socks], _lines(out, "Sinks:")))
    assert runs[0][0] == runs[1][0] and all(len(d) >= 4 for d in runs[0][0])
    assert [line.replace("TpuGopEncoder", "CudaGopEncoder") for line in runs[1][1]] \
        == runs[0][1] == [f"Sinks: encoded RTP rtp+h264://127.0.0.1:{port} .. +2 "
                          f"(encoder=CudaGopEncoder)"]


@pytest.mark.parametrize("spec", ["cavlc", "pcm"])
def test_multi_relay_streams_the_jax_datagrams_per_stream(spec, capsys):
    runs = []
    with catchers(2) as (port, socks):
        argv = MULTI_BASE + [f"--sink=rtp+h264://127.0.0.1:{port}", f"--encoder={spec}"]
        for app, extra in ((multi_relay, ["--device=cpu"]), (jax_multi_relay, [])):
            assert app.run(argv + extra) == 0
            out = capsys.readouterr().out
            per = re.findall(r"#\d+=(\d+)/(\d+)", out)
            assert per == [("4", "4")] * 2, out
            runs.append(([drain(s) for s in socks], _lines(out, "Sinks:")))
    assert runs[0] == runs[1]
    assert all(len(d) >= 4 for d in runs[0][0])
    assert runs[0][1] == [f"Sinks: encoded RTP rtp+h264://127.0.0.1:{port} .. +2 "
                          f"(encoder={ENCODERS[spec]})"]


def test_relay_encoded_sink_writes_the_jax_sdp(tmp_path, capsys):
    texts = []
    for app, extra in ((relay, ["--device=cpu"]), (jax_relay, [])):
        path = tmp_path / f"{app.__name__}.sdp"
        rc = app.run(RELAY_BASE + ["--max-frames=2", "--encoder=pcm",
                                   "--sink=rtp+h264://127.0.0.1:15704",
                                   f"--sdp-file={path}"] + extra)
        assert rc == 0 and f"SDP written: {path}" in capsys.readouterr().out
        # the origin line carries a random session id
        texts.append(re.sub(r"(?m)^o=- \d+ ", "o=- <id> ", path.read_text()))
    assert texts[0] == texts[1]
    assert "H264/90000" in texts[0] and "packetization-mode=1" in texts[0]


@pytest.mark.parametrize("extra", [
    ["--sink=rtp+h265://127.0.0.1:56470", "--encoder=cavlc:qp=40"],
    ["--sink=rtp+h265://127.0.0.1:56470", "--encoder=pcm"],
    ["--sink=rtp+h265://127.0.0.1:56470"],
    ["--sink=rtp+h264://127.0.0.1:56470", "--encoder=ffmpeg"],
    ["--sink=rtp+h264://127.0.0.1:56470", "--encoder=cavlc:qp=99"],
    ["--sink=rtp+h264://127.0.0.1:56470", "--encoder=nope"],
    ["--sink=rtp+h264://127.0.0.1:56470", "--rtcp-schedule=cron"],
    ["--sink=rtp+h264://127.0.0.1:port"],
], ids=["cavlc_h265", "pcm_h265", "auto_h265", "ffmpeg_missing", "cavlc_qp",
        "unknown_backend", "rtcp_schedule", "bad_port"])
@pytest.mark.parametrize("apps", [(relay, jax_relay), (multi_relay, jax_multi_relay)],
                         ids=["relay", "multi_relay"])
def test_encoded_sink_refusals_equal_jax(apps, extra, capsys, monkeypatch):
    """A ValueError of the encoder factory: rc 2 and the same one line."""
    for mod in (encoder, jax_encoder):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    base = RELAY_BASE if apps[0] is relay else MULTI_BASE
    rc = apps[0].run(base + extra + ["--device=cpu"])
    got = capsys.readouterr().err
    assert rc == apps[1].run(base + extra) == 2
    want = capsys.readouterr().err
    assert got == want and len(got.strip().splitlines()) == 1


# ---------------------------------------- tests/test_flag_matrix.py's rows ----

MATRIX_BASE = ["--source=test", "--width=64", "--height=48", "--fps=30",
               "--max-frames=2", "--batch=2", "--workers=1", "--status-interval=60",
               "--device=cpu"]
FUSED = ("Fused enhance+encode: frames stay in HBM as pixels; the host "
         "receives quantized levels only")
FUSED_GOP = FUSED + " (GOP 4, recon resident in HBM)"
FUSED_REFUSED = ("--fused-encode requires --sink=rtp+h264:// with "
                 "--encoder=tpu[...] (and no --io=gst or --ref-frame)")
FUSED_MESH_INTRA = ("Fused enhance+encode over mesh {'data': 2, 'space': 1} (2 devices, "
                    "frame-per-device; frames stay in HBM as pixels)")
FUSED_MESH_STATE = ("--fused-encode with --mesh requires IDR GOP boundaries and "
                    "per-frame-synchronous state to stay on one chip: no gdr, no cpb")
MATRIX = [
    ("plain", ["--sink=null"], 0, None),
    ("clahe_ref_frame", ["--sink=null", "--op=clahe", "--ref-frame"], 0, None),
    ("hist_downsample", ["--sink=null", "--op=clahe", "--hist-downsample=2"], 0, None),
    ("encoded_sink_cavlc", ["--sink=rtp+h264://127.0.0.1:56470",
                            "--encoder=cavlc:qp=40"], 0, None),
    ("encoded_cpb", ["--sink=rtp+h264://127.0.0.1:56473", "--bitrate=800",
                     "--encoder=cavlc:cpb=500"], 0, None),
    ("encoded_tpu_intra", ["--sink=rtp+h264://127.0.0.1:56479",
                           "--encoder=tpu:qp=40"], 0, None),
    ("encoded_tpu_intra_i4_chromah_overlap", ["--sink=rtp+h264://127.0.0.1:56480",
                                              "--encoder=tpu:qp=40:i4:chromah:overlap"],
     0, None),
    ("encoded_tpu_bitpack", ["--sink=rtp+h264://127.0.0.1:56484",
                             "--encoder=tpu:qp=40:bitpack"], 0, None),
    ("encoded_tpu_gop_deblock", ["--sink=rtp+h264://127.0.0.1:56471",
                                 "--encoder=tpu:qp=40:gop=4:deblock"], 0, None),
    ("encoded_tpu_gdr", ["--sink=rtp+h264://127.0.0.1:56472",
                         "--encoder=tpu:qp=40:gdr=3"], 0, None),
    ("encoded_tpu_gdr_search", ["--sink=rtp+h264://127.0.0.1:56481",
                                "--encoder=tpu:qp=40:gdr=3:search=2"], 0, None),
    ("encoded_tpu_fastsub", ["--sink=rtp+h264://127.0.0.1:56482",
                             "--encoder=tpu:qp=40:gop=4:search=2:fastsub"], 0, None),
    ("encoded_tpu_gop_search", ["--sink=rtp+h264://127.0.0.1:56488",
                                "--encoder=tpu:qp=40:gop=4:search=2"], 0, None),
    ("encoded_tpu_parts", ["--sink=rtp+h264://127.0.0.1:56487",
                           "--encoder=tpu:qp=40:gop=4:search=2:parts"], 0, None),
    ("fused_intra", ["--sink=rtp+h264://127.0.0.1:56474", "--encoder=tpu:qp=40",
                     "--fused-encode"], 0, FUSED),
    ("fused_gop", ["--sink=rtp+h264://127.0.0.1:56475", "--encoder=tpu:qp=40:gop=4",
                   "--fused-encode"], 0, FUSED_GOP),
    ("fused_bitpack", ["--sink=rtp+h264://127.0.0.1:56483",
                       "--encoder=tpu:qp=40:gop=4:bitpack", "--fused-encode"],
     0, FUSED_GOP),
    ("downsample_x_mesh", ["--sink=null", "--hist-downsample=2", "--mesh=2x1"],
     2, "not supported"),
    ("downsample_x_ref", ["--sink=null", "--op=clahe", "--hist-downsample=2",
                          "--ref-frame"], 2, "not supported"),
    ("fused_x_null_sink", ["--sink=null", "--fused-encode"], 2, FUSED_REFUSED),
    ("fused_mesh_intra", ["--sink=rtp+h264://127.0.0.1:56476", "--encoder=tpu:qp=40",
                          "--mesh=2x1", "--fused-encode"], 0, FUSED_MESH_INTRA),
    ("fused_mesh_x_gdr", ["--sink=rtp+h264://127.0.0.1:56489", "--encoder=tpu:qp=40:gdr=3",
                          "--mesh=1x1", "--fused-encode"], 2, FUSED_MESH_STATE),
    ("fused_mesh_x_cpb", ["--sink=rtp+h264://127.0.0.1:56490", "--bitrate=800",
                          "--encoder=tpu:gop=4:cpb=500", "--mesh=1x1", "--fused-encode"],
     2, FUSED_MESH_STATE),
    ("fused_mesh_x_batch", ["--sink=rtp+h264://127.0.0.1:56491",
                            "--encoder=tpu:qp=40:gop=4", "--mesh=1x1", "--fused-encode"],
     2, "--batch=2 must be a positive multiple of mesh devices x GOP frames (1 x 4)"),
    ("fused_x_ref_frame", ["--sink=rtp+h264://127.0.0.1:56477", "--op=clahe",
                           "--ref-frame", "--encoder=tpu:qp=40", "--fused-encode"],
     2, FUSED_REFUSED),
    ("fused_x_cpu_encoder", ["--sink=rtp+h264://127.0.0.1:56478",
                             "--encoder=cavlc:qp=40", "--fused-encode"], 2, FUSED_REFUSED),
]


@pytest.mark.parametrize("name,extra,rc,msg", MATRIX, ids=[m[0] for m in MATRIX])
def test_flag_matrix_on_the_port(name, extra, rc, msg, capfd):
    """A refusal's ``msg`` is its one line on stderr; a run's, a line it
    prints.  A run on a mesh of two takes a gloo group of two processes,
    whose rank 0 prints."""
    if "--mesh=2x1" in extra and rc == 0:
        rcs = launch.run_on_mesh((2, 1), launch.run_relay, (MATRIX_BASE + extra,),
                                 device_type="cpu", timeout=110.0)
        got = 0 if rcs == [0, 0] else rcs
    else:
        got = relay.run(MATRIX_BASE + extra)
    out, err = capfd.readouterr()
    assert got == rc, f"{name}: rc {got} != {rc}; stderr: {err[-400:]}"
    if msg is not None and rc:
        assert msg in err and len(err.strip().splitlines()) == 1, err
    elif msg is not None:
        assert msg in out.splitlines() and "errors=0" in out, out


@pytest.mark.parametrize("name", ["fused_x_null_sink", "fused_x_ref_frame",
                                  "fused_x_cpu_encoder", "fused_mesh_x_gdr",
                                  "fused_mesh_x_cpb", "fused_mesh_x_batch"])
def test_fused_refusals_are_the_jax_relays(name, capsys):
    extra, msg = next((m[1], m[3]) for m in MATRIX if m[0] == name)
    rc = relay.run(MATRIX_BASE + extra)
    got = capsys.readouterr()
    jax_rc = jax_relay.run([a for a in MATRIX_BASE if a != "--device=cpu"] + extra)
    want = capsys.readouterr()
    assert rc == jax_rc == 2
    assert got.err == want.err == msg + "\n"


@pytest.mark.parametrize("spec", ["tpu:qp=40:i4:chromah", "tpu:qp=40:gop=4:search=2"])
def test_relay_fused_streams_the_jax_datagrams(spec, capsys):
    """``--fused-encode`` on ``--device=cpu`` sends the JAX fused relay's
    datagrams and prints its lines (the class name and the line on how the
    device program is made aside); the JAX relay too runs ``tpu:i4:chromah``
    as plain ``tpu`` when fused."""
    runs = []
    with catchers(1) as (port, (sock,)):
        argv = RELAY_BASE + [f"--sink=rtp+h264://127.0.0.1:{port}", f"--encoder={spec}",
                             "--fused-encode"]
        for app, extra in ((relay, ["--device=cpu"]), (jax_relay, [])):
            assert app.run(argv + extra) == 0
            out = capsys.readouterr().out
            assert "6 frames emitted" in out and "errors=0" in out
            runs.append((drain(sock), [
                " ".join(re.sub(r"-?\d+(\.\d+)?", "#", line.replace("Tpu", "Cuda")).split())
                for line in out.splitlines()
                if line.strip() and not line.startswith(("Building the kernels",
                                                         "Compiling device program"))]))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) >= 6
    assert runs[0][1] == runs[1][1]
    fused_line = FUSED_GOP if "gop=" in spec else FUSED
    assert re.sub(r"\d+", "#", fused_line) in runs[0][1]


def test_relay_fused_mesh_streams_the_single_card_datagrams(capfd):
    """``--mesh=2x1 --fused-encode`` on a gloo group of two processes
    (``--device=cpu``) prints the JAX relay's lines on its 2x1 CPU mesh (the
    class names and the line on how the device program is made aside) and
    sends the datagrams of the port's single-card fused relay, which
    ``test_relay_fused_streams_the_jax_datagrams`` holds to the JAX fused
    relay's: one GOP of 4 a rank, rank 0's qp on both ranks.  The JAX mesh
    relay's own datagrams are not the reference: its feeder cuts batches by
    timing, and every batch starts a GOP on each device, so where its first
    batch is short its IDRs move; in a group the port's feeder cuts whole
    batches."""
    runs = []
    with catchers(1) as (port, (sock,)):
        argv = RELAY_BASE + ["--batch=8", "--max-frames=8",
                             f"--sink=rtp+h264://127.0.0.1:{port}",
                             "--encoder=tpu:qp=40:gop=4:search=2", "--fused-encode"]
        rcs = launch.run_on_mesh((2, 1), launch.run_relay,
                                 (argv + ["--mesh=2x1", "--device=cpu"],),
                                 device_type="cpu", timeout=110.0)
        runs.append((rcs, capfd.readouterr().out, drain(sock)))
        runs.append(([jax_relay.run(argv + ["--mesh=2x1"])], capfd.readouterr().out,
                     drain(sock)))
        runs.append(([relay.run(argv + ["--device=cpu"])], capfd.readouterr().out,
                     drain(sock)))
    lines = [[" ".join(re.sub(r"-?\d+(\.\d+)?", "#", line.replace("Tpu", "Cuda")).split())
              for line in out.splitlines()
              if line.strip() and not line.startswith(("Building the kernels",
                                                       "Compiling device program"))]
             for _, out, _ in runs[:2]]
    assert [r[0] for r in runs] == [[0, 0], [0], [0]]
    assert "8 frames emitted" in runs[0][1] and "errors=0" in runs[0][1]
    assert lines[0] == lines[1]
    assert ("Fused enhance+encode over mesh {'data': 2, 'space': 1} (2 devices, "
            "GOP-per-device; frames stay in HBM as pixels)") in runs[0][1].splitlines()
    assert runs[0][2] == runs[2][2] and len(runs[0][2]) >= 8


def test_rtp_receiver_records_the_fused_relays_access_units(tmp_path, capsys):
    """The port's ``rtp_receiver`` records the fused relay's stream, and it
    is the unfused relay's, access unit for access unit."""
    recordings = []
    for fused in (["--fused-encode"], []):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as free:
            free.bind(("127.0.0.1", 0))
            port = free.getsockname()[1]
        out = tmp_path / f"rx{len(recordings)}.h264"
        result = []
        rx = threading.Thread(target=lambda: result.append(rtp_receiver.run(
            ["--kind=h264", "--max-frames=6", "--timeout=15", f"--output={out}",
             f"--port={port}", "--host=127.0.0.1"])), daemon=True)
        rx.start()
        time.sleep(0.3)
        assert relay.run(RELAY_BASE + [f"--sink=rtp+h264://127.0.0.1:{port}",
                                       "--encoder=tpu:qp=40:gop=4:search=2:deblock",
                                       "--device=cpu"] + fused) == 0
        rx.join(timeout=20)
        assert not rx.is_alive() and result == [0]
        printed = capsys.readouterr().out
        assert "Received 6 access units" in printed
        assert (FUSED_GOP in printed.splitlines()) == bool(fused)
        recordings.append(out.read_bytes())
    assert recordings[0] == recordings[1] and recordings[0]


SPEC_REFUSALS = [
    ("cavlc:qp=30:gdr=3:gop=8", "replaces gop"),
    ("tpu:qp=30:gdr=3:search=2:refs=2", "gdr requires refs=1"),
    ("tpu:qp=30:cpb=500", "cpb needs bitrate control"),
    ("tpu:gop=8:cpb=500:overlap", "does not compose with overlap"),
    ("cavlc:initdelay=100", "initdelay requires cpb"),
    ("cavlc:qp=30:search=2", "need a gop"),
    ("tpu:qp=30:halfpel", "need a gop"),
    ("cavlc:qp=30:gop=8:halfpel", "require search"),
    ("cavlc:qp=30:gop=8:refs=2", "requires search"),
    ("tpu:qp=30:gop=8:fastsub", "require search"),
    ("tpu:qp=30:gop=8:search=2:fastsub:quarterpel", "replaces halfpel"),
]


@pytest.mark.parametrize("spec,msg", SPEC_REFUSALS, ids=[s[0] for s in SPEC_REFUSALS])
def test_encoder_spec_refusals_on_the_port(spec, msg):
    with pytest.raises(ValueError, match=msg):
        encoder.make_encoder(spec, 64, 48, bitrate_kbps=400)

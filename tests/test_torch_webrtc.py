"""The port's WebRTC control plane against the JAX package's.

- ``io/viewers/``: the four pages are byte-equal copies, and the port's
  ``SignalingServer`` serves the five viewer paths with the JAX server's
  bodies and content types, and 404 for anything else.
- ``io/signaling.py``: a port client in a JAX server's room and a JAX client
  in a port server's room (and the port alone) exchange offer, answer and
  ICE on loopback, in the room dialect and the peer-id dialect.
- ``io/webrtc_controller.py``: ``WebRtcSession`` of both packages over
  ``tests/fake_webrtc.py`` on the cases of tests/test_webrtc_controller.py,
  with the same counts.
- ``apps/sender.py``: both senders in ``--signaling-only`` mode (plain,
  ``--audio``, ``--test-source``) and with webrtcbin over the fake stack,
  a viewer joining each: the same lines (the banner mapped: the port's
  names the card it runs on), the same shutdown line, return code 0.

Everything runs on 127.0.0.1 with ports from the OS; the tests wait on
events, not on fixed sleeps, and each sender runs for 1.5 s.
"""

import re
import socket
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from opencv_opencl_tpu.apps import sender as jax_sender
from opencv_opencl_tpu.io import signaling as jax_signaling
from opencv_opencl_tpu.io import webrtc_controller as jax_controller
from opencv_opencl_tpu_torch.apps import sender
from opencv_opencl_tpu_torch.io import sdp, signaling, webrtc_controller
from tests.fake_webrtc import FakeWebRtcApi, FakeWebRtcGst

ROOT = Path(__file__).resolve().parent.parent
PAGES = ("viewer.html", "stats.html", "protocol.js", "protocol_test.html")
PATHS = ("/", "/viewer.html", "/stats.html", "/protocol.js", "/protocol_test.html")
PKG = {"port": signaling, "jax": jax_signaling}
WAIT = 10.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ the viewers ----


def test_viewer_pages_are_byte_equal_copies():
    for name in PAGES:
        ours = (ROOT / "opencv_opencl_tpu_torch/io/viewers" / name).read_bytes()
        assert ours == (ROOT / "opencv_opencl_tpu/io/viewers" / name).read_bytes(), name


def _get(url: str) -> tuple[int, str, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_port_server_serves_the_jax_servers_pages():
    servers = [signaling.SignalingServer().start(),
               jax_signaling.SignalingServer().start()]
    try:
        for path in PATHS + ("/etc/passwd", "/viewers/viewer.html"):
            ours, theirs = (_get(f"http://127.0.0.1:{s.port}{path}") for s in servers)
            assert ours == theirs, path
            assert ours[0] == (200 if path in PATHS else 404), path
        assert "javascript" in _get(f"http://127.0.0.1:{servers[0].port}/protocol.js")[1]
    finally:
        for s in servers:
            s.stop()


# ---------------------------------------------------------- the signaling ----


@pytest.mark.parametrize("server,sender_side,viewer_side", [
    ("jax", "port", "jax"), ("port", "jax", "port"), ("port", "port", "port")],
    ids=["port-client-in-jax-room", "jax-client-in-port-room", "port-only"])
def test_signaling_offer_answer_and_ice_interoperate(server, sender_side,
                                                     viewer_side):
    srv = PKG[server].SignalingServer().start()
    got = {}
    events = {k: threading.Event() for k in
              ("ready", "offer", "answer", "ice", "peer_ice", "viewer_ice",
               "registered")}

    def put(key, value):
        got[key] = value
        events[key].set()

    try:
        tx = PKG[sender_side].SignalingClient(
            srv.url, room="r", client_type="sender",
            on_ready=lambda: put("ready", True),
            on_answer=lambda s: put("answer", s),
            on_ice=lambda c, m: put("peer_ice" if "peer" in c else "ice", (c, m)),
            reconnect_delay_s=0.05).start()
        assert tx.wait_connected(WAIT)

        def on_offer(sdp_text, frm):
            put("offer", (sdp_text, frm))
            rx.send_answer(sdp.build_answer(sdp.parse_sdp(sdp_text)), to=frm)
            rx.send_ice("candidate:room 1 UDP 7", 0)
            rx.send_ice_peer("candidate:peer 1 UDP 9", 1, peer_id=frm)

        rx = PKG[viewer_side].SignalingClient(
            srv.url, room="r", client_type="viewer", on_offer=on_offer,
            on_ice=lambda c, m: put("viewer_ice", (c, m)),
            on_registered=lambda i: put("registered", i),
            reconnect_delay_s=0.05).start()
        assert rx.wait_connected(WAIT)
        assert events["ready"].wait(WAIT) and events["registered"].wait(WAIT)
        offer = sdp.build_offer([sdp.media_for_codec("h264", "video", mid="video0")])
        tx.send_offer(offer)
        for key in ("offer", "answer", "ice", "peer_ice"):
            assert events[key].wait(WAIT), key
        tx.send_ice("candidate:sender 1 UDP 5", 0)
        assert events["viewer_ice"].wait(WAIT)
        assert got["offer"][0] == offer and got["offer"][1]
        assert sdp.parse_sdp(got["answer"]).medias[0].direction == "recvonly"
        assert got["ice"] == ("candidate:room 1 UDP 7", 0)
        assert got["peer_ice"] == ("candidate:peer 1 UDP 9", 1)
        assert got["viewer_ice"] == ("candidate:sender 1 UDP 5", 0)
        assert tx.remote_peer_id == got["registered"] and rx.my_id == got["registered"]
        assert tx.bad_messages == rx.bad_messages == 0
        rx.stop()
        tx.stop()
    finally:
        srv.stop()


@pytest.mark.parametrize("raw", ['{"type": "ice", "sdpMLineIndex": "x"}', "[1, 2]",
                                 "not json", '{"type": "ice-candidate", '
                                 '"candidate": {"candidate": ""}}'])
def test_client_drops_malformed_messages_as_the_jax_client(raw):
    counts = []
    for mod in (signaling, jax_signaling):
        calls = []
        c = mod.SignalingClient("ws://127.0.0.1:9", room="r",
                                on_ice=lambda *a: calls.append(a))
        c._dispatch(raw)
        counts.append((c.bad_messages, calls))
    assert counts[0] == counts[1]


# ---------------------------------------------------- the webrtc controller ----


PIPE = ("v4l2src ! video/x-raw,format=NV12 ! omxh264enc ! rtph264pay ! "
        "webrtcbin name=sendrecv stun-server=stun://stun.example:19302")


class StubClient:
    def __init__(self, fail=False):
        self.offers, self.ice, self.peer_ice = [], [], []
        self.fail = fail
        self.remote_peer_id = None

    def send_offer(self, sdp_text):
        if self.fail:
            raise RuntimeError("signaling down")
        self.offers.append(sdp_text)

    def send_ice(self, cand, mline):
        if self.fail:
            raise RuntimeError("signaling down")
        self.ice.append((cand, mline))

    def send_ice_peer(self, cand, mline, peer_id=None):
        self.peer_ice.append((cand, mline, peer_id))


def _counts(session, client):
    return {"offers_sent": session.offers_sent,
            "answers_applied": session.answers_applied,
            "ice_sent": session.ice_sent, "ice_applied": session.ice_applied,
            "resets": session.resets, "errors": session.errors,
            "published": len(client.offers), "ice_out": len(client.ice),
            "peer_ice_out": len(client.peer_ice)}


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _scenario(mod, name):
    """Run one case of tests/test_webrtc_controller.py on ``mod``'s
    ``WebRtcSession``; returns its counts and what the case checks."""
    logs = []
    client = StubClient(fail=name == "outage")
    session = mod.WebRtcSession(FakeWebRtcGst(), FakeWebRtcApi(), PIPE, client=client,
                                on_log=logs.append)
    seen = {}
    if name == "missing_webrtcbin":
        bare = mod.WebRtcSession(FakeWebRtcGst(), FakeWebRtcApi(),
                                 "videotestsrc ! fakesink", on_log=logs.append)
        with pytest.raises(ValueError, match="webrtcbin"):
            bare.start()
        return {"raised": True}
    session.start()
    if name == "answer":
        seen["applied"] = session.handle_answer(
            sdp.build_answer(sdp.parse_sdp(client.offers[0])))
        seen["remote"] = session.webrtc.remote_desc.type
    elif name == "malformed_answer":
        seen["bad"] = session.handle_answer("this is not sdp")
        seen["then"] = session.handle_answer(
            sdp.build_answer(sdp.parse_sdp(client.offers[0])))
    elif name == "trickle":
        session.webrtc.trickle_ice(0, "candidate:1 1 UDP 2113937151 ...")
        seen["in"] = session.handle_remote_ice("candidate:2 1 UDP 1 ...", 0)
        seen["empty"] = session.handle_remote_ice("", 0)
        seen["remote_ice"] = session.webrtc.remote_ice
    elif name == "reset":
        first = session.pipeline
        seen["reset"] = session.reset()
        seen["new_pipeline"] = session.pipeline is not first
        seen["fresh_offers"] = session.webrtc.offers_created
    elif name == "ice_failure":
        session.webrtc.set_ice_state("failed")
        seen["reset"] = _wait(lambda: session.resets == 1)
        seen["logged"] = any("failed" in line for line in logs)
    elif name == "after_stop":
        session.stop()
        seen["reset"] = session.reset()
        seen["answer"] = session.handle_answer("v=0\r\n")
        seen["ice"] = session.handle_remote_ice("candidate:x", 0)
    elif name == "resend":
        seen["resend"] = session.resend_offer()
        seen["same"] = client.offers[0] == client.offers[1]
    elif name == "peer_dialect":
        session.webrtc.trickle_ice(0, "candidate:a")
        client.remote_peer_id = "viewer-9"
        session.webrtc.trickle_ice(1, "candidate:b")
        seen["peer_ice"] = client.peer_ice
    session.stop()
    return {**_counts(session, client), **seen}


SCENARIOS = {
    "offer": dict(offers_sent=1, published=1),
    "answer": dict(offers_sent=1, answers_applied=1, applied=True, remote="answer"),
    "malformed_answer": dict(errors=1, answers_applied=1, bad=False, then=True),
    "trickle": dict(ice_sent=1, ice_applied=1, ice_out=1, **{"in": True},
                    empty=False, remote_ice=[(0, "candidate:2 1 UDP 1 ...")]),
    "missing_webrtcbin": dict(raised=True),
    "outage": dict(offers_sent=1, errors=1, published=0),
    "reset": dict(resets=1, published=2, offers_sent=2, reset=True,
                  new_pipeline=True, fresh_offers=1),
    "ice_failure": dict(resets=1, errors=1, published=2, reset=True, logged=True),
    "after_stop": dict(reset=False, answer=False, ice=False),
    "resend": dict(offers_sent=2, published=2, resend=True, same=True),
    "peer_dialect": dict(ice_sent=2, ice_out=1, peer_ice_out=1,
                         peer_ice=[("candidate:b", 1, "viewer-9")]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_counts_equal_the_jax_controllers(name):
    ours = _scenario(webrtc_controller, name)
    theirs = _scenario(jax_controller, name)
    assert ours == theirs
    for key, want in SCENARIOS[name].items():
        assert ours[key] == want, (key, ours)


def test_controller_probe_without_gi_is_false_as_in_the_jax_package():
    assert webrtc_controller.gi_webrtc_available() is \
        jax_controller.gi_webrtc_available() is False


# ------------------------------------------------------------- the sender ----


def _patch_registered_event(monkeypatch, module):
    """Make ``module.SignalingClient`` set ``event`` once a sender is
    registered in its room (the server adds it to the room as it answers),
    instead of sleeping."""
    event = threading.Event()

    class Client(module.SignalingClient):
        def _parse_msg(self, msg):
            action = super()._parse_msg(msg)
            if msg.get("type") == "registered" and self.client_type == "sender":
                event.set()
            return action

    monkeypatch.setattr(module, "SignalingClient", Client)
    return event


def _patch_set_up_event(monkeypatch, app):
    """Make ``app`` set ``event`` when it first reads the monotonic clock,
    which it does once set up, as its run's timer starts."""
    event = threading.Event()

    def monotonic():
        event.set()
        return time.monotonic()

    monkeypatch.setattr(app, "time", types.SimpleNamespace(monotonic=monotonic,
                                                           sleep=time.sleep))
    return event


def _fake_sessions(monkeypatch, controller_mod):
    sessions = []

    def build(pipeline_desc, client=None, webrtc_name="sendrecv", on_log=print):
        sessions.append(controller_mod.WebRtcSession(
            FakeWebRtcGst(), FakeWebRtcApi(), pipeline_desc, client=client,
            webrtc_name=webrtc_name, on_log=on_log))
        return sessions[-1]

    monkeypatch.setattr(controller_mod, "gi_webrtc_available", lambda: True)
    monkeypatch.setattr(controller_mod, "build_gi_session", build)
    return sessions


def _drive_sender(app, sig_mod, controller_mod, extra, monkeypatch, capsys, gi):
    """Run ``app`` with a self-served room for 1.5 s while a viewer
    joins, answers the offer and sends one ICE candidate; returns the return
    code, the printed lines with the port masked, and the fake sessions."""
    registered = _patch_registered_event(monkeypatch, sig_mod)
    sessions = _fake_sessions(monkeypatch, controller_mod) if gi else None
    set_up = _patch_set_up_event(monkeypatch, app)
    port = free_port()
    url = f"ws://127.0.0.1:{port}"
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", app.run(
        [f"--ws={url}", "--room=s", "--serve-signaling", "--duration=1.5"] + extra)))
    t.start()
    answered = threading.Event()

    def on_offer(sdp_text, frm):
        viewer.send_answer(sdp.build_answer(sdp.parse_sdp(sdp_text)))
        viewer.send_ice("candidate:v 1 UDP 99 127.0.0.1 9 typ host", 0)
        answered.set()

    try:
        # the viewer joins once the sender is in its room and has finished
        # setting up (its signaling client bound, its media plane built)
        assert registered.wait(WAIT) and set_up.wait(WAIT)
        # a short backoff: once the sender's server is gone the viewer
        # retries, and stop() waits for the retry's sleep
        viewer = signaling.SignalingClient(url, room="s", client_type="viewer",
                                           on_offer=on_offer, reconnect_delay_s=0.05)
        viewer.start()
        assert viewer.wait_connected(WAIT) and answered.wait(WAIT)
    finally:
        t.join(timeout=WAIT)
        viewer.stop()
    out = capsys.readouterr()
    assert out.err == ""
    text = re.sub(r"\(\d+ bytes\)", "(N bytes)", out.out.replace(str(port), "PORT"))
    return rc["rc"], text.splitlines(), sessions


@pytest.mark.parametrize("extra,gi", [
    (["--signaling-only"], False), (["--signaling-only", "--audio"], False),
    (["--signaling-only", "--test-source"], False), ([], True)],
    ids=["signaling-only", "audio", "test-source", "webrtcbin"])
def test_sender_prints_the_jax_senders_lines(extra, gi, monkeypatch, capsys):
    runs = []
    for app, sig_mod, controller_mod in ((sender, signaling, webrtc_controller),
                                         (jax_sender, jax_signaling, jax_controller)):
        runs.append(_drive_sender(app, sig_mod, controller_mod, extra, monkeypatch,
                                  capsys, gi))
    (rc, lines, sessions), (jax_rc, jax_lines, jax_sessions) = runs
    assert rc == jax_rc == 0
    # the one wording divergence: the port's banner names the card
    assert lines[0] == "=== GPU WebRTC sender ===" and jax_lines[0] == "=== TPU WebRTC sender ==="
    lines[0] = jax_lines[0]
    # the signaling thread's lines and the main thread's may interleave
    assert sorted(lines) == sorted(jax_lines)
    shutdown = [line for line in lines if line.startswith("Sender shut down")]
    if gi:
        assert shutdown == ["Sender shut down: 1 viewer(s), 1 offer(s), 1 answer(s), "
                            "reconnects=0; webrtcbin: offers=2 answers=1 ice_out=0 "
                            "ice_in=1 resets=0"]
        assert sessions[0].answers_applied == jax_sessions[0].answers_applied == 1
        assert "Media pipeline PLAYING (webrtcbin negotiation wired)" in lines
    else:
        assert shutdown == ["Sender shut down: 1 viewer(s), 1 offer(s), 1 answer(s), "
                            "reconnects=0"]
        assert "Signaling-only mode — control plane only" in lines
    assert any(line.startswith("Remote ICE candidate (mline=0): candidate:v")
               for line in lines)


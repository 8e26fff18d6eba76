"""Live webrtcbin negotiation controller.

The port's own copy of ``opencv_opencl_tpu/io/webrtc_controller.py`` (host
code; gi is imported inside the functions that need it).

Drives a pipeline's ``webrtcbin`` element through the full reference
negotiation flow (``webrtc/sender.cpp:182-251,269-339``):

- ``on-negotiation-needed`` -> ``create-offer`` -> promise ->
  ``set-local-description`` -> publish the offer SDP through the
  :class:`~opencv_opencl_tpu_torch.io.signaling.SignalingClient`;
- incoming ``answer`` -> ``set-remote-description``;
- ``on-ice-candidate`` out / ``add-ice-candidate`` in, both ways;
- session recovery (``vad2connection.cpp:65-160,367-400``): a watchdog on
  ``ice-connection-state`` plus :meth:`reset` tearing the pipeline down and
  rebuilding it behind a reentrancy latch, so a failed/disconnected peer
  session renegotiates from scratch.

The Gst stack is injected (like :mod:`opencv_opencl_tpu_torch.io.gst_adapter`):
``WebRtcSession(gst=..., api=...)`` runs against the real python-gi modules
(:meth:`WebRtcApi.from_gi`) on GStreamer hosts and against the in-repo fake
double (``tests/fake_webrtc.py``) everywhere else, so the complete signal
flow — offer produced BY the element, answer applied TO it, trickle ICE in
both directions — is exercised without hardware.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

__all__ = ["WebRtcApi", "WebRtcSession", "gi_webrtc_available"]


def gi_webrtc_available() -> bool:
    """True when python-gi with Gst + GstWebRTC + GstSdp is importable."""
    try:
        import gi  # noqa: F401

        gi.require_version("Gst", "1.0")
        gi.require_version("GstWebRTC", "1.0")
        gi.require_version("GstSdp", "1.0")
        from gi.repository import Gst, GstSdp, GstWebRTC  # noqa: F401

        return True
    except Exception:
        return False


class WebRtcApi:
    """Seam over the GstWebRTC/GstSdp description types.

    The controller never touches those modules directly — it converts
    between SDP text and session-description objects through this API, so
    the fake double can substitute plain-python descriptions.
    """

    def __init__(self, gst: Any, gst_webrtc: Any, gst_sdp: Any) -> None:
        self.gst = gst
        self.gst_webrtc = gst_webrtc
        self.gst_sdp = gst_sdp

    @classmethod
    def from_gi(cls) -> "WebRtcApi":
        import gi

        gi.require_version("Gst", "1.0")
        gi.require_version("GstWebRTC", "1.0")
        gi.require_version("GstSdp", "1.0")
        from gi.repository import Gst, GstSdp, GstWebRTC

        if not Gst.is_initialized():
            Gst.init(None)
        return cls(Gst, GstWebRTC, GstSdp)

    def desc_text(self, desc: Any) -> str:
        """SDP text of a (GstWebRTC)SessionDescription."""
        return desc.sdp.as_text()

    def answer_from_text(self, sdp_text: str) -> Any:
        """Build an ANSWER session description from SDP text
        (``sender.cpp:295-322``: sdp_message_parse_buffer + new).

        GstSdp signals malformed input through SDPResult return codes,
        not exceptions — check them, or handle_answer would apply an
        EMPTY description to webrtcbin for garbage peer SDP."""
        ok = self.gst_sdp.SDPResult.OK
        res, sdpmsg = self.gst_sdp.SDPMessage.new()
        if res != ok:
            raise ValueError(f"SDPMessage.new failed: {res}")
        res = self.gst_sdp.sdp_message_parse_buffer(
            sdp_text.encode(), sdpmsg)
        if res != ok:
            raise ValueError(f"unparseable SDP: {res}")
        return self.gst_webrtc.WebRTCSessionDescription.new(
            self.gst_webrtc.WebRTCSDPType.ANSWER, sdpmsg)


def build_gi_session(pipeline_desc: str, client: Any = None,
                     webrtc_name: str = "sendrecv",
                     on_log: Callable[[str], None] = print) -> "WebRtcSession":
    """Construct a :class:`WebRtcSession` on the REAL python-gi stack.

    ``apps/sender.py`` calls this when :func:`gi_webrtc_available`; tests
    monkeypatch it (and the availability probe) to inject the fake stack.
    """
    api = WebRtcApi.from_gi()
    from gi.repository import GLib

    return WebRtcSession(api.gst, api, pipeline_desc, client=client,
                         webrtc_name=webrtc_name, glib=GLib, on_log=on_log)


class WebRtcSession:
    """Owns one webrtcbin pipeline and its negotiation state.

    Parameters
    ----------
    gst: the ``Gst`` module (real gi or the fake double); must expose
        ``parse_launch``, ``Promise``, ``State``.
    api: a :class:`WebRtcApi` (or the fake equivalent).
    pipeline_desc: gst-launch description containing a webrtcbin named
        ``webrtc_name`` (see ``io.gst.webrtc_pipeline*`` builders).
    client: a started :class:`SignalingClient` used to publish offers and
        ICE (may be None for tests that inspect ``sent`` directly).
    glib: optional GLib module — when given, ``start()`` spins a mainloop
        daemon thread for bus/signal dispatch (real gi needs this).
    """

    def __init__(
        self,
        gst: Any,
        api: Any,
        pipeline_desc: str,
        client: Any = None,
        webrtc_name: str = "sendrecv",
        glib: Any = None,
        on_log: Callable[[str], None] = print,
    ) -> None:
        self.gst = gst
        self.api = api
        self.pipeline_desc = pipeline_desc
        self.client = client
        self.webrtc_name = webrtc_name
        self.glib = glib
        self.on_log = on_log
        self.pipeline: Any = None
        self.webrtc: Any = None
        self.last_offer_text: str | None = None
        # counters mirrored into the sender's shutdown report
        self.offers_sent = 0
        self.answers_applied = 0
        self.ice_sent = 0
        self.ice_applied = 0
        self.resets = 0
        self.errors = 0
        self._lock = threading.RLock()
        self._is_resetting = False  # vad2connection.cpp:31 latch
        self._stopped = False
        self._mainloop = None
        self._mainloop_thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WebRtcSession":
        with self._lock:
            self._build_and_play()
        if self.glib is not None and self._mainloop is None:
            self._mainloop = self.glib.MainLoop()
            self._mainloop_thread = threading.Thread(
                target=self._mainloop.run, daemon=True, name="webrtc-glib")
            self._mainloop_thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._teardown()
        if self._mainloop is not None:
            self._mainloop.quit()
            if self._mainloop_thread is not None:
                self._mainloop_thread.join(timeout=5)
            self._mainloop = None

    def reset(self) -> bool:
        """Tear down and rebuild the whole pipeline for a fresh
        negotiation (``vad2connection.cpp:65-160``).  Returns False when
        a reset is already in flight (the ``is_reconnecting`` latch,
        ``:31,391-395``) or the session is stopped."""
        with self._lock:
            if self._is_resetting or self._stopped:
                return False
            self._is_resetting = True
            try:
                self._teardown()
                self.last_offer_text = None
                self._build_and_play()
                self.resets += 1
                self.on_log("WebRTC session reset: pipeline rebuilt, "
                            "renegotiating")
            finally:
                self._is_resetting = False
            return True

    def _build_and_play(self) -> None:
        self.pipeline = self.gst.parse_launch(self.pipeline_desc)
        self.webrtc = self.pipeline.get_by_name(self.webrtc_name)
        if self.webrtc is None:
            raise ValueError(
                f"pipeline has no webrtcbin named {self.webrtc_name!r}")
        # signal wiring (sender.cpp:420-422)
        self.webrtc.connect("on-negotiation-needed",
                            self._on_negotiation_needed)
        self.webrtc.connect("on-ice-candidate", self._on_ice_candidate)
        try:
            self.webrtc.connect("notify::ice-connection-state",
                                self._on_ice_state)
        except Exception:
            pass  # property notify not supported by this double
        bus = self.pipeline.get_bus()
        if bus is not None:
            try:
                bus.add_signal_watch()
                bus.connect("message", self._on_bus_message)
            except Exception:
                pass
        self.pipeline.set_state(self.gst.State.PLAYING)

    def _teardown(self) -> None:
        if self.pipeline is not None:
            try:
                self.pipeline.set_state(self.gst.State.NULL)
            except Exception:
                pass
        self.pipeline = None
        self.webrtc = None

    # -- webrtcbin -> signaling (sender.cpp:182-251) -----------------------

    def _on_negotiation_needed(self, element: Any, *args: Any) -> None:
        promise = self.gst.Promise.new_with_change_func(
            self._on_offer_created, element)
        element.emit("create-offer", None, promise)

    def _on_offer_created(self, promise: Any, element: Any,
                          *args: Any) -> None:
        reply = promise.get_reply()
        if reply is None:  # create-offer failed/interrupted
            self.errors += 1
            return
        offer = reply.get_value("offer")
        p2 = self.gst.Promise.new()
        element.emit("set-local-description", offer, p2)
        p2.interrupt()  # fire-and-forget (sender.cpp:199-201)
        text = self.api.desc_text(offer)
        self.last_offer_text = text
        self.offers_sent += 1
        self.on_log(f"Offer created by webrtcbin ({len(text)} bytes) — "
                    "set-local-description, publishing")
        if self.client is not None:
            try:
                self.client.send_offer(text)
            except Exception:
                self.errors += 1  # signaling down: reconnect will re-offer

    def _on_ice_candidate(self, element: Any, mline: int,
                          candidate: str, *args: Any) -> None:
        self.ice_sent += 1
        if self.client is None:
            return
        try:
            peer = getattr(self.client, "remote_peer_id", None)
            if peer and hasattr(self.client, "send_ice_peer"):
                # peer-id dialect session (vad.cpp:119-144): nested
                # ice-candidate addressed to the answering peer
                self.client.send_ice_peer(candidate, int(mline),
                                          peer_id=peer)
            else:
                self.client.send_ice(candidate, int(mline))
        except Exception:
            self.errors += 1

    def _on_ice_state(self, element: Any, *args: Any) -> None:
        state = None
        try:
            state = element.get_property("ice-connection-state")
        except Exception:
            return
        name = getattr(state, "value_nick", None) or str(state)
        self.on_log(f"ICE connection state: {name}")
        if "failed" in name.lower():
            # vad2connection.cpp:367-400: failed ICE -> full reset
            self.errors += 1
            threading.Thread(target=self.reset, daemon=True,
                             name="webrtc-reset").start()

    def _on_bus_message(self, bus: Any, msg: Any) -> None:
        t = getattr(msg, "type", None)
        name = getattr(t, "value_nick", None) or str(t)
        if "error" in name.lower():
            self.errors += 1
            self.on_log(f"Pipeline bus ERROR: {msg}")

    # -- signaling -> webrtcbin (sender.cpp:269-339) -----------------------

    def handle_answer(self, sdp_text: str) -> bool:
        """Apply a remote answer (``set-remote-description``)."""
        with self._lock:
            if self.webrtc is None:
                return False
            try:
                answer = self.api.answer_from_text(sdp_text)
            except Exception:
                self.errors += 1  # malformed peer SDP must not kill us
                return False
            p = self.gst.Promise.new()
            self.webrtc.emit("set-remote-description", answer, p)
            p.interrupt()
            self.answers_applied += 1
            return True

    def handle_remote_ice(self, candidate: str, mline: int) -> bool:
        """Apply a remote trickle-ICE candidate (``sender.cpp:323-333``)."""
        with self._lock:
            if self.webrtc is None or not candidate:
                return False
            self.webrtc.emit("add-ice-candidate", int(mline), candidate)
            self.ice_applied += 1
            return True

    def resend_offer(self) -> bool:
        """Re-publish the current local offer (a late viewer joined after
        negotiation: the reference's room server replays the offer, ours
        asks the sender on ``ready``)."""
        if self.last_offer_text is None or self.client is None:
            return False
        try:
            self.client.send_offer(self.last_offer_text)
        except Exception:
            self.errors += 1
            return False
        self.offers_sent += 1
        return True

"""WebRTC signaling: JSON-over-WebSocket client + room-relay server.

The port's own copy of ``opencv_opencl_tpu/io/signaling.py`` (host code, the
same messages); its server serves the port's copy of the viewer pages,
``opencv_opencl_tpu_torch/io/viewers/``.

Rebuilds the reference's L5 control plane:

- **Client** — the sender-side signaling of ``webrtc/sender.cpp``:
  connect, send ``{type: join, room, clientType}`` (``:369-376``), publish
  SDP offers (``:216-222``) and ICE candidates (``:238-251``), dispatch
  incoming ``answer`` / ``ice`` / ``ready`` messages (``:269-339``).
  Session recovery reproduces ``webrtc/vad2connection.cpp``: on socket
  close or error, schedule a reconnect with 2-3 s backoff behind an
  ``is_reconnecting`` latch (``:31,367-400``) and re-join the room.
- **Server** — the room relay the reference assumed as an external service
  (``ws://...:8080``): forwards offer/answer/ice between the sender and
  viewers in a room, emits ``ready`` to the sender when a viewer joins.
  Having it in-repo makes the control plane self-contained and testable.

Messages are JSON dicts; SDP blobs are opaque strings relayed verbatim.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Callable

__all__ = ["SignalingClient", "SignalingServer"]


class SignalingClient:
    """Threaded asyncio WebSocket signaling client with auto-reconnect."""

    def __init__(
        self,
        url: str,
        room: str,
        client_type: str = "sender",
        on_answer: Callable[[str], None] | None = None,
        on_ice: Callable[[str, int], None] | None = None,
        on_ready: Callable[[], None] | None = None,
        on_connected: Callable[[], None] | None = None,
        on_offer: Callable[[str, str | None], None] | None = None,
        on_registered: Callable[[str], None] | None = None,
        reconnect_delay_s: float = 2.0,
        max_reconnects: int | None = None,
    ) -> None:
        self.url = url
        self.room = room
        self.client_type = client_type
        self.on_answer = on_answer or (lambda sdp: None)
        self.on_ice = on_ice or (lambda cand, mline: None)
        self.on_ready = on_ready or (lambda: None)
        self.on_connected = on_connected or (lambda: None)
        self.on_offer = on_offer or (lambda sdp, frm: None)
        self.on_registered = on_registered or (lambda my_id: None)
        self.my_id: str | None = None          # peer-id dialect: registered
        self.remote_peer_id: str | None = None  # ...and the answering peer
        self.reconnect_delay_s = reconnect_delay_s
        self.max_reconnects = max_reconnects
        self.reconnect_count = 0
        self.bad_messages = 0  # malformed peer messages dropped
        self.is_reconnecting = False  # the vad2connection reentrancy latch
        self._loop: asyncio.AbstractEventLoop | None = None
        self._ws = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._connected = threading.Event()

    # ---- public API (any thread) ----

    def start(self) -> "SignalingClient":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="signaling")
        self._thread.start()
        return self

    def wait_connected(self, timeout: float = 10.0) -> bool:
        return self._connected.wait(timeout)

    def send_offer(self, sdp: str) -> None:
        self._send({"type": "offer", "room": self.room, "sdp": sdp})

    def send_ice(self, candidate: str, sdp_mline_index: int) -> None:
        self._send({
            "type": "ice", "room": self.room,
            "candidate": candidate, "sdpMLineIndex": sdp_mline_index,
        })

    def send_answer(self, sdp: str, to: str | None = None) -> None:
        """Viewer-side answer; ``to`` selects the peer-id dialect."""
        msg = {"type": "answer", "room": self.room, "sdp": sdp}
        if to:
            msg["to"] = to
        self._send(msg)

    def send_ice_peer(self, candidate: str, sdp_mline_index: int,
                      peer_id: str | None = None) -> None:
        """Peer-id dialect (reference ``webrtc/vad.cpp:118-144``):
        ``ice-candidate`` with a nested candidate object, sdpMid derived
        from the mline index, and an optional ``to`` peer."""
        mid = "audio1" if sdp_mline_index == 1 else "video0"
        msg = {
            "type": "ice-candidate",
            "candidate": {
                "candidate": candidate,
                "sdpMLineIndex": sdp_mline_index,
                "sdpMid": mid,
            },
        }
        if peer_id:
            msg["to"] = peer_id
        self._send(msg)

    def stop(self) -> None:
        self._stop.set()
        if self._loop is not None:
            ws = self._ws
            if ws is not None:
                # a client parked in `async for` only notices _stop once the
                # connection drops — close the socket from its own loop
                try:
                    asyncio.run_coroutine_threadsafe(
                        ws.close(), self._loop
                    ).result(timeout=5)
                except Exception:
                    pass
            try:
                self._loop.call_soon_threadsafe(lambda: None)  # wake
            except RuntimeError:
                pass  # loop already closed
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ---- internals ----

    def _send(self, msg: dict) -> None:
        # capture once: the reconnect loop's finally block can null _ws
        # between a check and the send (TOCTOU)
        ws = self._ws
        if self._loop is None or ws is None:
            raise RuntimeError("not connected")
        coro = ws.send(json.dumps(msg))
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop:
            # called from a message callback on the client's own event-loop
            # thread (e.g. send_offer from on_ready): blocking on .result()
            # here would deadlock the loop — fire and forget instead
            self._loop.create_task(coro)
        else:
            asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout=5)

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        import websockets

        self._loop = asyncio.get_running_loop()
        while not self._stop.is_set():
            try:
                async with websockets.connect(self.url) as ws:
                    self._ws = ws
                    self.is_reconnecting = False
                    await ws.send(json.dumps({
                        "type": "join", "room": self.room,
                        "clientType": self.client_type,
                    }))
                    self._connected.set()
                    self.on_connected()
                    async for raw in ws:
                        self._dispatch(raw)
            except Exception:
                pass
            finally:
                self._ws = None
                self._connected.clear()
            if self._stop.is_set():
                break
            # vad2connection-style recovery: latch + fixed backoff
            if (self.max_reconnects is not None
                    and self.reconnect_count >= self.max_reconnects):
                break
            self.is_reconnecting = True
            self.reconnect_count += 1
            await asyncio.sleep(self.reconnect_delay_s)

    def _dispatch(self, raw: str) -> None:
        """Understands BOTH reference signaling dialects:

        - room dialect (``webrtc/sender.cpp:269-339``): ``answer`` /
          flat ``ice`` / ``ready``.
        - peer-id dialect (``webrtc/vad.cpp:69-115``, ``atc.cpp`` same):
          ``registered`` carrying our ``id``; ``answer``/``offer`` carrying
          ``from``; ``ice-candidate`` with a NESTED candidate object whose
          empty candidate string is the end-of-candidates signal (ignored,
          vad.cpp:100-104).
        """
        try:
            msg = json.loads(raw)
        except json.JSONDecodeError:
            self.bad_messages += 1
            return
        if not isinstance(msg, dict):
            self.bad_messages += 1  # arrays/scalars from a broken peer
            return
        try:
            action = self._parse_msg(msg)
        except (AttributeError, TypeError, ValueError, KeyError):
            # a malformed field (string where an object was expected,
            # non-numeric index, ...) must not tear down the websocket —
            # the receive loop's except would force a full reconnect
            self.bad_messages += 1
            return
        if action is not None:
            # user callbacks run OUTSIDE the malformed-message guard: an
            # application bug must surface (via the receive loop), not be
            # silently blamed on the peer
            action()

    def _parse_msg(self, msg: dict):
        """Field extraction/coercion only (may raise on malformed input);
        returns the callback invocation to run, or None."""
        t = msg.get("type")
        if t == "answer":
            sdp = msg.get("sdp") or msg.get("answer", {}).get("sdp", "")
            frm = msg.get("from")
            if frm:
                self.remote_peer_id = frm
            return lambda: self.on_answer(sdp)
        if t == "offer":
            sdp = msg.get("sdp", "")
            frm = msg.get("from")
            return lambda: self.on_offer(sdp, frm)
        if t == "registered":
            self.my_id = msg.get("id")
            my = self.my_id
            return lambda: self.on_registered(my)
        if t == "ice":
            cand = msg.get("candidate", "")
            ml = int(msg.get("sdpMLineIndex", 0))
            return lambda: self.on_ice(cand, ml)
        if t == "ice-candidate":
            cand = msg.get("candidate") or {}
            cand_str = cand.get("candidate", "")
            if not cand_str:
                return None  # end-of-candidates signal
            frm = msg.get("from")
            if frm:
                self.remote_peer_id = frm
            ml = int(cand.get("sdpMLineIndex", 0))
            return lambda: self.on_ice(cand_str, ml)
        if t == "ready":
            return self.on_ready
        return None


class SignalingServer:
    """Room-based relay server (the external ws://host:8080 service).

    Senders and viewers join rooms; offer/ice from the sender fan out to
    viewers, answer/ice from a viewer route to the sender, and the sender
    gets a ``ready`` when a viewer joins.

    Plain HTTP GETs on the same port serve the viewer pages
    (``/viewer.html``, ``/stats.html``, ``/protocol.js``; ``/`` is the
    viewer) so a browser needs no separate web server — point it at
    ``http://host:port/`` and the page's default ws URL is already
    right.  The reference assumed an external HTTP server for its
    ``webrtc/*.html``; serving them in-process makes the control plane
    self-contained.  Disable with ``serve_pages=False``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 serve_pages: bool = True) -> None:
        self.host = host
        self.port = port
        self.serve_pages = serve_pages
        self.rooms: dict[str, dict] = {}
        self._peers: dict[str, object] = {}  # peer-id -> websocket
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._stop_event: asyncio.Event | None = None

    def start(self) -> "SignalingServer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="signaling-server")
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("signaling server failed to start")
        return self

    @property
    def url(self) -> str:
        return f"ws://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._loop is not None and self._stop_event is not None:
            self._loop.call_soon_threadsafe(self._stop_event.set)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        import websockets

        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        async with websockets.serve(
            self._handler, self.host, self.port,
            process_request=self._process_request if self.serve_pages
            else None,
        ) as server:
            self.port = server.sockets[0].getsockname()[1]
            self._started.set()
            await self._stop_event.wait()

    _PAGES = {
        "/": ("viewer.html", "text/html; charset=utf-8"),
        "/viewer.html": ("viewer.html", "text/html; charset=utf-8"),
        "/stats.html": ("stats.html", "text/html; charset=utf-8"),
        "/protocol.js": ("protocol.js",
                         "application/javascript; charset=utf-8"),
        "/protocol_test.html": ("protocol_test.html",
                                "text/html; charset=utf-8"),
    }

    def _process_request(self, connection, request):
        """Serve the viewer pages to plain HTTP GETs; None lets the
        WebSocket handshake proceed."""
        if "websocket" in request.headers.get("Upgrade", "").lower():
            return None
        from http import HTTPStatus
        from importlib import resources

        from websockets.datastructures import Headers
        from websockets.http11 import Response

        path = request.path.split("?", 1)[0]
        entry = self._PAGES.get(path)
        if entry is None:
            return Response(HTTPStatus.NOT_FOUND, "Not Found", Headers(
                [("Content-Type", "text/plain")]), b"not found\n")
        name, ctype = entry
        body = (resources.files("opencv_opencl_tpu_torch.io") / "viewers"
                / name).read_bytes()
        return Response(HTTPStatus.OK, "OK", Headers(
            [("Content-Type", ctype),
             ("Content-Length", str(len(body)))]), body)

    def _room(self, name: str) -> dict:
        return self.rooms.setdefault(name, {"sender": None, "viewers": set()})

    async def _handler(self, ws) -> None:
        joined_room = None
        role = None
        # peer-id dialect: every connection gets an id at join time and is
        # told via {"type": "registered", "id": ...}; relayed messages carry
        # "from" so receivers can address replies with "to"
        # (``webrtc/vad.cpp:71-77,137-138`` message shapes)
        import secrets

        peer_id = secrets.token_hex(4)
        self._peers[peer_id] = ws
        try:
            async for raw in ws:
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                t = msg.get("type")
                if t == "join":
                    joined_room = msg.get("room", "default")
                    room = self._room(joined_room)
                    role = msg.get("clientType", "viewer")
                    await ws.send(json.dumps(
                        {"type": "registered", "id": peer_id}))
                    if role == "sender":
                        room["sender"] = ws
                    else:
                        room["viewers"].add(ws)
                        if room["sender"] is not None:
                            await room["sender"].send(json.dumps({
                                "type": "ready", "room": joined_room,
                                "from": peer_id,
                            }))
                elif joined_room is not None:
                    room = self._room(joined_room)
                    to = msg.get("to")
                    if to and to in self._peers:
                        targets = [self._peers[to]]
                    elif ws is room["sender"]:
                        targets = list(room["viewers"])
                    else:
                        targets = [room["sender"]] if room["sender"] else []
                    msg["from"] = peer_id
                    out = json.dumps(msg)
                    for t_ws in targets:
                        try:
                            await t_ws.send(out)
                        except Exception:
                            pass
        finally:
            self._peers.pop(peer_id, None)
            if joined_room is not None:
                room = self._room(joined_room)
                if ws is room.get("sender"):
                    room["sender"] = None
                room["viewers"].discard(ws)

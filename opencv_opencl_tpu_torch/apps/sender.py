"""WebRTC sender (<- reference ``webrtc/sender.cpp`` family +
``vadcamera.cpp`` audio + ``vad.cpp`` test sender + ``vad2connection.cpp``
recovery).

Counterpart of ``opencv_opencl_tpu/apps/sender.py`` on the port's ``gst``,
``sdp``, ``signaling`` and ``webrtc_controller``: the same flags, defaults,
printed lines and return codes, except the banner, which names the card
the port runs on.  The sender launches no kernel: its media plane is a
GStreamer pipeline and its control plane is host code, so it takes no
``--device=cpu``; ``--device`` names the camera, as in the JAX package.

Usage:
  python -m opencv_opencl_tpu_torch.apps.sender [--ws=ws://host:8080]
      [--room=default] [--width=1280] [--height=720] [--fps=30]
      [--codec=h264|h265|vp8] [--bitrate=200] [--device=/dev/video0]
      [--audio] [--test-source] [--serve-signaling] [--signaling-only]
      [--duration=seconds]

Flags and defaults mirror ``webrtc/sender.cpp:37-69``.  ``--audio`` embeds
the silent Opus track in the sender pipeline (``vadcamera.cpp:415-487``);
``--test-source`` selects the two-track videotestsrc+audiotestsrc VP8/Opus
pipeline of ``webrtc/vad.cpp:312-330``.  On GStreamer hosts the media plane
launches for real; everywhere the control plane carries REAL parseable SDP:
the offer is generated for the exact media configuration (io.sdp) and
answers are parsed, so the signaling path is valid end-to-end with no
placeholder blobs.  ``--serve-signaling`` starts the in-repo room-relay
server.  ``--signaling-only`` forces control-plane mode even with GStreamer.
"""

from __future__ import annotations

import sys
import time

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args)


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {
            "ws": str, "room": str, "width": int, "height": int, "fps": int,
            "codec": str, "bitrate": int, "device": str, "audio": bool,
            "test-source": bool,
            "serve-signaling": bool, "signaling-only": bool, "duration": float,
        },
    )
    ws_url = opts.get("ws", "ws://192.168.25.69:8080")
    room = opts.get("room", "default")
    width = opts.get("width", 1280)
    height = opts.get("height", 720)
    fps = opts.get("fps", 30)
    codec = opts.get("codec", "h264")
    bitrate = opts.get("bitrate", 200)
    device = opts.get("device", "/dev/video0")
    duration = opts.get("duration")
    audio = opts.get("audio", False)
    test_source = opts.get("test-source", False)

    from opencv_opencl_tpu_torch.io import gst, sdp, webrtc_controller
    from opencv_opencl_tpu_torch.io.signaling import SignalingClient, SignalingServer

    webrtc_name = "sendrecv"
    if test_source:
        # two-track VP8 + Opus test pipeline (vad.cpp)
        pipeline = gst.vad_test_pipeline()
        webrtc_name = "webrtcbin"
        medias = [sdp.media_for_codec("vp8", "video", mid="video0"),
                  sdp.media_for_codec("opus", "audio", mid="audio1")]
    else:
        enc = gst.EncoderConfig(codec=codec, bitrate_kbps=bitrate)
        if codec == "vp8":
            pipeline = gst.webrtc_pipeline_vp8(
                device=device, width=width, height=height, fps=fps)
        else:
            pipeline = gst.webrtc_pipeline(
                enc, device=device, width=width, height=height, fps=fps)
        medias = [sdp.media_for_codec(codec, "video", mid="video0")]
        if audio:
            # silent Opus track keeps browser AV-sync happy (vadcamera.cpp)
            pipeline = pipeline + " " + gst.silent_audio_branch(
                webrtc_name="sendrecv")
            medias.append(sdp.media_for_codec("opus", "audio", mid="audio1"))
    print("=== GPU WebRTC sender ===")
    print(f"Signaling: {ws_url}  room={room}")
    print(f"Config: {width}x{height}@{fps} codec={codec} "
          f"bitrate={bitrate} kbps device={device} "
          f"audio={'on' if audio or test_source else 'off'}")
    print(f"Pipeline: {pipeline}")

    server = None
    if opts.get("serve-signaling"):
        import urllib.parse

        u = urllib.parse.urlparse(ws_url)
        server = SignalingServer(host=u.hostname or "127.0.0.1",
                                 port=u.port or 8080).start()
        ws_url = server.url
        print(f"Started in-process signaling server at {ws_url}")

    signaling_only = bool(opts.get("signaling-only"))
    state = {"viewers": 0, "offers": 0, "answers": 0}
    media = {"session": None}  # set once the gi webrtcbin plane starts

    def on_ready():
        state["viewers"] += 1
        session = media["session"]
        if session is not None:
            # the live webrtcbin already negotiated (or is negotiating):
            # replay its actual local offer to the late viewer
            print(f"Viewer joined (total {state['viewers']}) — "
                  "re-publishing webrtcbin offer")
            if session.resend_offer():
                state["offers"] += 1
            else:
                print("(no local offer yet — negotiation in progress)")
            return
        print(f"Viewer joined (total {state['viewers']}) — sending offer")
        # control-plane mode generates the equivalent offer for the same
        # media configuration (no webrtcbin to create one)
        client.send_offer(sdp.build_offer(medias))
        state["offers"] += 1

    def on_answer(sdp_text):
        sess = sdp.parse_sdp(sdp_text)
        kinds = "+".join(m.kind for m in sess.medias)
        session = media["session"]
        if session is not None and session.handle_answer(sdp_text):
            print(f"Received answer ({len(sess.medias)} m-line(s): {kinds}) "
                  "— set-remote-description applied to webrtcbin")
        else:
            print(f"Received answer ({len(sess.medias)} m-line(s): {kinds}) "
                  "— set-remote-description")
        state["answers"] += 1

    def on_ice(cand, mline):
        session = media["session"]
        applied = (session is not None
                   and session.handle_remote_ice(cand, mline))
        suffix = " -> add-ice-candidate" if applied else ""
        print(f"Remote ICE candidate (mline={mline}): {cand[:60]}{suffix}")

    def on_connected():
        print(f"Connected to signaling, joined room '{room}' as sender")
        session = media["session"]
        if session is not None and client.reconnect_count > 0:
            # vad2connection.cpp:65-160: a recovered signaling session
            # rebuilds the media pipeline and renegotiates from scratch
            session.reset()

    client = SignalingClient(
        ws_url, room=room, client_type="sender",
        on_ready=on_ready, on_answer=on_answer, on_ice=on_ice,
        on_connected=on_connected,
        reconnect_delay_s=2.0,
    ).start()

    if not client.wait_connected(10):
        print("ERROR: could not reach signaling server", file=sys.stderr)
        client.stop()
        if server:
            server.stop()
        return 1

    shell = None
    if signaling_only:
        print("Signaling-only mode — control plane only")
    elif webrtc_controller.gi_webrtc_available():
        # the real thing: webrtcbin negotiation wired to the signaling
        # client (sender.cpp:182-251,269-339)
        media["session"] = webrtc_controller.build_gi_session(
            pipeline, client=client, webrtc_name=webrtc_name).start()
        print("Media pipeline PLAYING (webrtcbin negotiation wired)")
    elif gst.gst_available():
        shell = gst.GstShell(pipeline)
        shell.start()
        print("Media pipeline launched via gst-launch (negotiation not "
              "wired — control-plane offer only; install python-gi for "
              "live webrtcbin negotiation)")
    else:
        print("Media plane unavailable (no GStreamer) — control plane only")

    try:
        t0 = time.monotonic()
        while duration is None or time.monotonic() - t0 < duration:
            time.sleep(0.2)
    except KeyboardInterrupt:
        print("\nInterrupted.")
    finally:
        if media["session"] is not None:
            media["session"].stop()
        if shell:
            shell.stop()
        client.stop()
        if server:
            server.stop()
    line = (f"Sender shut down: {state['viewers']} viewer(s), "
            f"{state['offers']} offer(s), {state['answers']} answer(s), "
            f"reconnects={client.reconnect_count}")
    session = media["session"]
    if session is not None:
        line += (f"; webrtcbin: offers={session.offers_sent} "
                 f"answers={session.answers_applied} "
                 f"ice_out={session.ice_sent} ice_in={session.ice_applied} "
                 f"resets={session.resets}")
    print(line)
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()

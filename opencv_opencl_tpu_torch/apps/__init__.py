"""CLI apps of the port (counterpart of ``opencv_opencl_tpu.apps``).

reference binary            app module
--------------------------  -----------------------------
OpenCVequalHist family,
OpenCLequalHist, improvement relay
(extension: N streams on
one card)                   multi_relay
(extension: PC-side RTP
player/recorder)            rtp_receiver
(extension: replay an
H.26x ES over RTP)          h26x_stream

The image, video-file and WebRTC sender apps of the JAX package are not
ported yet (ROADMAP.md Queue 1).
"""

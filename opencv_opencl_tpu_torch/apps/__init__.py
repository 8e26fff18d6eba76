"""CLI apps of the port (counterpart of ``opencv_opencl_tpu.apps``).

reference binary            app module
--------------------------  -----------------------------
OpenCVequalHist family,
OpenCLequalHist, improvement relay
(extension: N streams on
one card)                   multi_relay

The image, video-file, WebRTC sender and RTP receiver apps of the JAX
package are not ported yet (ROADMAP.md Queue 1).
"""

"""CLI apps of the port (counterpart of ``opencv_opencl_tpu.apps``),
mirroring the reference programs 1:1 (SURVEY §2 / §7.6).

reference binary            app module
--------------------------  -----------------------------
singlecolor / single        histeq_image
m2 / single2                histeq_image --method comparison (see m2_bench)
clahe1frame                 clahe_image
1frameMeasure               parity_bench
CLAHECompare / clahevideo   clahe_video
AirplanMP4                  airplan_mp4
OpenCVequalHist family,
OpenCLequalHist, improvement relay
webrtc/sender family        sender
(extension: N streams on
one card)                   multi_relay
(extension: PC-side RTP
player/recorder)            rtp_receiver
(extension: replay an
H.26x ES over RTP)          h26x_stream

Every app that launches a kernel runs on the card and takes
``--device=cpu`` for the tests; the sender launches none.
"""

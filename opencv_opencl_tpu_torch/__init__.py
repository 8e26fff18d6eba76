"""opencv_opencl_tpu_torch — the PyTorch + CUDA port of ``opencv_opencl_tpu``.

The JAX package beside it is the reference: every function here is tested
against its JAX counterpart on the same inputs, and through it against the
numpy golden models and cv2.  The port imports no JAX and nothing of the
JAX package: the modules it needs that import no JAX (frame layouts, the
golden models, counters, timing, the feeder, queues and resequencer) are
copied into it under the same relative paths.

Subpackages
-----------
core      frame layouts (``frames``) and the numpy golden models (``golden``)
ops       histogram, equalizeHist and CLAHE on tensors; ``ops/cuda`` holds
          the hand-written Hopper kernels' wrappers (sources in ``csrc/``)
          beside their plain PyTorch versions
models    the NV12 enhancement step, ``Enhancer`` and ``StreamingEnhancer``,
          and the named presets of the reference programs
parallel  the same step over a (data, space) mesh of processes on
          ``torch.distributed``: ``ShardedEnhancer``, ``run_on_mesh``
runtime   the frame feeder, queues and resequencer, the device-to-host
          handoff the feeder materialises, the rate governors and the
          stream mux
io        sources and sinks of NV12 frames (synthetic, file, raw), the native
          RTP/RTCP data plane, SDP, the GStreamer pipeline strings, the host
          H.264 encoders (I_PCM, CAVLC intra and GOP, over the C++ rows of
          ``native``), RFC 6184/7798 RTP, the encoder factory and MP4
apps      the command-line apps: ``relay``, ``multi_relay``,
          ``rtp_receiver`` and ``h26x_stream``
metrics   streaming counters and timing
utils     environment report (torch, CUDA, card, power limit, kernels)
"""

from opencv_opencl_tpu_torch.version import __version__

__all__ = ["__version__"]

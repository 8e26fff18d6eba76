"""opencv_opencl_tpu_torch — the PyTorch + CUDA port of ``opencv_opencl_tpu``.

The JAX package beside it is the reference: every function here is tested
against its JAX counterpart on the same inputs, and through it against the
numpy golden models (``opencv_opencl_tpu.core.golden``) and cv2.  The port
imports no JAX.  From the JAX package it shares only the modules that
import no JAX: ``core``, ``runtime``, ``metrics`` and ``native``.

Subpackages
-----------
ops       CLAHE on tensors; ``ops/cuda`` holds the hand-written Hopper
          kernels (sources in ``csrc/``) beside their plain PyTorch versions
models    the NV12 enhancement step and the ``Enhancer``
runtime   the device-to-host handoff that lets ``runtime.FrameFeeder`` of
          the JAX package drive the port unchanged
utils     environment report (torch, CUDA, card, power limit, kernels)
"""

from opencv_opencl_tpu_torch.version import __version__

__all__ = ["__version__"]

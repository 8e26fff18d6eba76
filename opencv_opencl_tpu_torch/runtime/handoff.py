"""Hand a batch on the device back to host code that expects numpy.

``runtime/feeder.FrameFeeder`` materialises each batch with
``np.asarray(device_out)``, which the JAX package gets from
``jax.Array.__array__``.  A CUDA tensor has no such conversion, so the
port's ``process_batch`` returns a :class:`DeviceBatch`: it starts the
device-to-host copy into pinned memory on a side stream as soon as the
batch is enqueued, and ``__array__`` waits for that copy only.  The
port's copies of the JAX package's feeder and resequencer run on it
unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DeviceBatch"]


class DeviceBatch:
    """A device tensor whose host copy is under way.

    ``stream`` is the side stream for the copy; it waits for the work
    already enqueued on the tensor's current stream.  A CPU tensor needs
    no copy and is handed back as it is.
    """

    def __init__(self, tensor: torch.Tensor,
                 stream: torch.cuda.Stream | None = None) -> None:
        self.tensor = tensor
        self._event = None
        if tensor.device.type != "cuda":
            self._host = tensor
            return
        if stream is None:
            raise ValueError("a CUDA tensor needs a side stream for its copy")
        stream.wait_stream(torch.cuda.current_stream(tensor.device))
        with torch.cuda.stream(stream):
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            # the caching allocator must not hand the device memory to
            # another tensor before the copy has read it
            tensor.record_stream(stream)
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def numpy(self) -> np.ndarray:
        """The host copy as numpy, once the copy has finished."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.numpy()
        if dtype is not None and np.dtype(dtype) != arr.dtype:
            return arr.astype(dtype)
        return arr.copy() if copy else arr

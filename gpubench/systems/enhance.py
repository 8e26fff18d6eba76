"""The NV12 enhancement step: ``models/enhancer.build_enhance_fn`` over a
batch of the streams' frames, the output left on the card.

Stream ``s`` plays position ``t0 + s + k`` of the sequence at step ``k``
(one frame a stream a step), or one stream plays ``frames_per_stream``
consecutive positions a step; either way a step's batch is one contiguous
view of the sequence.  ``donate`` false keeps the sequence as it was made,
so the reference reads the same frames after the window.
"""

from __future__ import annotations

import torch

from gpubench import frames
from gpubench.reference import clahe

# frames the reference holds at once: its gathers take ~0.3 GB a 4K frame
REFERENCE_CHUNK = 4


class Step:
    def __init__(self, out: torch.Tensor, position: int, frames_: int):
        self.out = out
        self.position = position
        self.frames = frames_
        self.kinds = {"frames": frames_}
        self.parts = {}
        self._event = None
        if out.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def kept(self):
        return (self.position, self.out)


class System:
    """The configuration's step on ``device`` over the traffic's frames."""

    span = "enhance"

    def __init__(self, config: dict, traffic: frames.Traffic, seed: int, device):
        from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
        from opencv_opencl_tpu_torch.models.enhancer import (
            EnhancerConfig, build_enhance_fn)

        if traffic.streams > 1 and traffic.frames_per_stream > 1:
            raise ValueError("the enhance system takes several streams of one "
                             "frame a step, or one stream of several")
        if config["op"] != "clahe":
            raise ValueError("the enhance system's reference is CLAHE")
        self.width, self.height = config["width"], config["height"]
        self.chroma = config["chroma"]
        self.advance = traffic.frames_per_stream
        self.batch = traffic.streams * traffic.frames_per_stream
        self.period = traffic.period
        self.t0 = int(seed) % self.period
        self.check_steps = int(config["check_steps"])
        self.seq = frames.make_sequence(traffic, self.width, self.height, seed,
                                        self.batch, device)
        cfg = EnhancerConfig(op="clahe", clip_limit=float(config["clip_limit"]),
                             tile_grid=tuple(config["tile_grid"]),
                             chroma=ChromaPolicy(config["chroma"]))
        self.fn = build_enhance_fn(cfg, FrameSpec(width=self.width, height=self.height),
                                   donate=bool(config["donate"]))
        self.plan = clahe.make_plan(self.height, self.width, float(config["clip_limit"]),
                                    tuple(config["tile_grid"]))
        self.tiles = self.plan.num_tiles

    def position(self, k: int) -> int:
        return (self.t0 + k * self.advance) % self.period

    def issue(self, k: int) -> Step:
        p = self.position(k)
        return Step(self.fn(self.seq[p:p + self.batch]), p, self.batch)

    def checkable(self, k: int) -> bool:
        return True

    def warm_up(self, steps: int, hold: int) -> None:
        """``steps`` steps of the window's shape, ``hold`` outputs alive at
        once, so the allocator holds the blocks the window will use."""
        held = [self.issue(k) for k in range(max(steps, hold))]
        for s in held:
            s.wait()

    def compare(self, kept: list, control: bool = False) -> dict[str, int]:
        """Bytes of the kept steps' NV12 outputs that differ from the
        reference worked out again from the same frames (the enhanced luma
        and the chroma rows, one count).  With ``control`` also those of the
        control, the reference with its blend in bfloat16 put in the
        program's place, under ``control.<name>``."""
        h = self.height
        n = {"nv12_mismatch_px": 0}
        if control:
            n["control.nv12_mismatch_px"] = 0
        for position, out in kept:
            x = self.seq[position:position + self.batch]
            for i in range(0, self.batch, REFERENCE_CHUNK):
                xs, got = x[i:i + REFERENCE_CHUNK], out[i:i + REFERENCE_CHUNK]
                ref = clahe.clahe(xs[:, :h], self.plan)
                want_c = xs[:, h:] if self.chroma == "passthrough" else torch.full_like(
                    xs[:, h:], 128)
                n["nv12_mismatch_px"] += (int((got[:, :h] != ref).sum())
                                          + int((got[:, h:] != want_c).sum()))
                if control:
                    low = clahe.clahe(xs[:, :h], self.plan, torch.bfloat16)
                    n["control.nv12_mismatch_px"] += int((low != ref).sum())
        return n

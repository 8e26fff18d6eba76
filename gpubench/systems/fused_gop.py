"""The fused enhance + H.264 GOP step, as the relay's ``--fused-encode``
drives it: ``models/fused_encode.build_enhance_gop_fn`` on a stream's
consecutive frames, the reference pictures carried from step to step on the
card, the packed lanes brought down by ``runtime/handoff.DeviceBatch`` on a
side stream into pinned host memory.  A step is complete when its lanes
are on the host.

Each stream keeps its own chain and frame index; the window's chains start
at frame 0, an IDR, from zero pictures, and the warm-up runs a chain of its
own.  The steps that the check may keep are those right after a step that
starts a GOP, each kept with that step: the reference follows the chain
from the IDR through both steps, so it judges the lanes of both, the
picture the first hands to the second (through the second's first P frame)
and the picture the second hands on.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import frames
from gpubench.reference import clahe, gop as gop_ref


class Step:
    def __init__(self, batch, recon, position: int, idx0: int, frames_: int,
                 kinds: dict, parts: dict, gop_start):
        self.batch = batch            # a DeviceBatch
        self.recon = recon
        self.position = position
        self.idx0 = idx0
        self.frames = frames_
        self.kinds = kinds
        self.parts = parts
        self.gop_start = gop_start    # (position, idx0, batch) of the step before

    def wait(self) -> None:
        self.batch.numpy()

    def kept(self):
        """The step before, and this step with a copy of the picture it
        hands on, taken in stream order (the program may reuse its buffer)."""
        return (self.gop_start,
                (self.position, self.idx0, self.batch, tuple(t.clone() for t in self.recon)))


class System:
    span = "fused_encode"

    def __init__(self, config: dict, traffic: frames.Traffic, seed: int, device):
        from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
        from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig
        from opencv_opencl_tpu_torch.models.fused_encode import build_enhance_gop_fn

        if traffic.streams != 1:
            raise ValueError("the fused GOP system runs one stream")
        enc = config["encoder"]
        if config["op"] != "clahe" or config["chroma"] != "passthrough":
            raise ValueError("the fused GOP reference is CLAHE with chroma passthrough")
        if int(enc["refs"]) != 1:
            raise ValueError("the fused GOP reference takes one reference picture")
        self.device = torch.device(device)
        self.width, self.height = config["width"], config["height"]
        self.qp, self.gop = int(enc["qp"]), int(enc["gop"])
        self.search, self.subpel = int(enc["search"]), int(enc["subpel"])
        self.deblock = bool(enc["deblock"])
        self.batch = traffic.frames_per_stream
        self.period = traffic.period
        self.t0 = int(seed) % self.period
        self.check_steps = int(config["check_steps"])
        self.seq = frames.make_sequence(traffic, self.width, self.height, seed,
                                        self.batch, device)
        cfg = EnhancerConfig(op="clahe", clip_limit=float(config["clip_limit"]),
                             tile_grid=tuple(config["tile_grid"]),
                             chroma=ChromaPolicy(config["chroma"]))
        self.fn = build_enhance_gop_fn(
            cfg, FrameSpec(width=self.width, height=self.height), gop=self.gop,
            search=self.search, subpel=self.subpel, refs=int(enc["refs"]),
            deblock=self.deblock, device=self.device)
        self.plan = clahe.make_plan(self.height, self.width, float(config["clip_limit"]),
                                    tuple(config["tile_grid"]))
        self.tiles = self.plan.num_tiles
        self.d2h = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                    else None)
        self.reset()

    def _zero_recon(self):
        h16, w16 = -(-self.height // 16) * 16, -(-self.width // 16) * 16
        return tuple(torch.zeros(s, dtype=torch.uint8, device=self.device)
                     for s in ((h16, w16), (h16 // 2, w16 // 2), (h16 // 2, w16 // 2)))

    def reset(self) -> None:
        """A new chain: the next step is frame 0, an IDR."""
        self.recon = self._zero_recon()
        self.k0 = None
        self.gop_start = None

    def position(self, k: int) -> int:
        return (self.t0 + k * self.batch) % self.period

    def issue(self, k: int) -> Step:
        from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch

        if self.k0 is None:
            self.k0 = k
        idx0 = (k - self.k0) * self.batch
        p = self.position(k)
        t0 = time.perf_counter()
        packed, *rec = self.fn(self.seq[p:p + self.batch], self.qp, idx0, *self.recon)
        t1 = time.perf_counter()
        self.recon = tuple(rec)
        batch = DeviceBatch(packed, self.d2h)
        t2 = time.perf_counter()
        idr = sum(1 for i in range(self.batch) if (idx0 + i) % self.gop == 0)
        step = Step(batch, self.recon, p, idx0, self.batch,
                    {"frames": self.batch, "idr_frames": idr, "p_frames": self.batch - idr},
                    {"fn_s": t1 - t0, "handoff_s": t2 - t1}, self.gop_start)
        self.gop_start = (p, idx0, batch) if idx0 % self.gop == 0 else None
        return step

    def checkable(self, k: int) -> bool:
        """Whether step ``k`` follows a step that starts a GOP."""
        return (self.k0 is not None and k > self.k0
                and ((k - 1 - self.k0) * self.batch) % self.gop == 0)

    def warm_up(self, steps: int, hold: int) -> None:
        """A chain of its own through an IDR step and P steps, then a new
        chain for the window.  A kept pair holds two steps' lanes."""
        self.reset()
        held = [self.issue(k) for k in range(max(steps, hold + self.check_steps))]
        for s in held:
            s.wait()
        self.reset()

    def compare(self, kept: list, control: bool = False) -> dict[str, int]:
        """Mismatches of the kept pairs' lanes and of the picture the second
        step hands on, against the reference worked out from the same
        frames along the chain from the first step's IDR.  With ``control``
        also those of the control, the reference with the CLAHE blend in
        bfloat16 put in the program's place along its own chain, under
        ``control.<name>``."""
        n = {"lanes_mismatch": 0, "picture_mismatch_px": 0}
        if control:
            n.update({f"control.{k}": 0 for k in list(n)})

        def count(prefix, got, got_rec, want, want_rec):
            n[prefix + "lanes_mismatch"] += (int((got != want).sum())
                                             if got.shape == want.shape else want.numel())
            n[prefix + "picture_mismatch_px"] += sum(
                int((a != b).sum()) for a, b in zip(got_rec, want_rec))

        def chain(first, second, *blend):
            """The reference's lanes of both steps and its picture after them."""
            rec = self._zero_recon()
            lanes = []
            for position, idx0 in (first, second):
                want, rec = gop_ref.encode(
                    self.seq[position:position + self.batch], self.plan, self.qp, idx0,
                    self.gop, self.search, self.subpel, self.deblock, rec, *blend)
                lanes.append(want)
            return torch.cat(lanes), rec

        for (p1, i1, batch1), (p2, i2, batch2, recon) in kept:
            want, want_rec = chain((p1, i1), (p2, i2))
            got = torch.from_numpy(np.concatenate([batch1.numpy(), batch2.numpy()]))
            count("", got.to(want.device), recon, want, want_rec)
            if control:
                count("control.", *chain((p1, i1), (p2, i2), torch.bfloat16), want, want_rec)
        return n

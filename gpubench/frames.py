"""The general traffic generator: a pool of seeded NV12 frames on the card,
laid out as the sequence the streams play, from the parameters of a
``traffic/<mix>.json`` file.

The picture is ``chip_smoke.py``'s ``structured_y`` (line 600: a gradient
of 0-200 across the width and 0-55 down the height plus normal texture of
s.d. 18), panned as ``chip_smoke.py``'s ``moving_nv12`` (line 1288) pans it:
frame ``i`` is the canvas window at ``(i * dy, i * dx)`` luma pixels, the
chroma window at half the rows and the same bytes; ``still_left`` holds the
left columns still, ``noise_block`` puts a block of fresh uniform noise at
``(37 i, 101 i)`` modulo the free room.  Rewritten to generate on the card
from a ``torch.Generator``, and extended by ``sensor_noise_sd`` (fresh
normal noise on every frame) and ``object`` (a textured block that moves by
``step`` a frame) for a fixed camera.

The ``pool_frames`` distinct frames play forward then backward (0, 1, ...,
P-1, P-2, ..., 1, 0, ...), so the motion never jumps.  The sequence tensor
holds the frame of every position of one period and then the first
``batch - 1`` again, so that any ``batch`` consecutive positions are one
contiguous view and the window copies nothing to build its batches.
"""

from __future__ import annotations

import dataclasses

import torch

@dataclasses.dataclass(frozen=True)
class Traffic:
    """A traffic mix: ``streams`` streams, each sending ``frames_per_stream``
    consecutive frames a step, ``in_flight`` steps dispatched ahead in a
    closed loop, over ``pool_frames`` distinct frames."""

    streams: int
    frames_per_stream: int
    in_flight: int
    pool_frames: int
    pan: tuple[int, int] = (0, 0)
    texture_sd: float = 18.0
    chroma: tuple[int, int] = (96, 160)
    still_left: float = 0.0
    noise_block: tuple[int, int] | None = None
    sensor_noise_sd: float = 0.0
    object: dict | None = None

    @classmethod
    def from_json(cls, data: dict) -> "Traffic":
        unknown = set(data) - {f.name for f in dataclasses.fields(cls)} - {"why"}
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        kw = {k: v for k, v in data.items() if k != "why"}
        for key in ("pan", "chroma", "noise_block"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        t = cls(**kw)
        if min(t.streams, t.frames_per_stream, t.in_flight) < 1:
            raise ValueError("streams, frames_per_stream and in_flight must be >= 1")
        if t.pool_frames < 2 or min(t.pan) < 0:
            raise ValueError("pool_frames must be >= 2 and pan >= 0")
        return t

    @property
    def period(self) -> int:
        """Positions in one forward-and-back play of the pool."""
        return 2 * (self.pool_frames - 1)


def pingpong(t: int, pool_frames: int) -> int:
    """The pool frame at position ``t`` of the forward-and-back play."""
    period = 2 * (pool_frames - 1)
    t %= period
    return t if t < pool_frames else period - t


def _structured(gen, rows: int, cols: int, sd: float, device) -> torch.Tensor:
    base = (torch.linspace(0, 200, cols, dtype=torch.float32, device=device)[None, :]
            + torch.linspace(0, 55, rows, dtype=torch.float32, device=device)[:, None])
    noise = torch.randn((rows, cols), generator=gen, device=device) * sd
    return (base + noise).clamp(0, 255).to(torch.uint8)


def make_sequence(traffic: Traffic, width: int, height: int, seed: int,
                  batch: int, device) -> torch.Tensor:
    """uint8 (period + batch - 1, height * 3 / 2, width): the NV12 frame
    at each position of the play, generated on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    h, w, n = height, width, traffic.pool_frames
    dy, dx = traffic.pan
    ycan = _structured(gen, h + (n - 1) * dy, w + (n - 1) * dx,
                       traffic.texture_sd, device)
    lo, hi = traffic.chroma
    uvcan = torch.randint(lo, hi, (h // 2 + ((n - 1) * dy) // 2 + 1,
                                   w + (n - 1) * dx + 1),
                          generator=gen, device=device, dtype=torch.uint8)
    obj = traffic.object
    if obj is not None:
        oh, ow = obj["size"]
        otex = torch.randint(0, 256, (oh, ow), generator=gen, device=device,
                             dtype=torch.uint8)
        start = torch.randint(0, 1 << 30, (2,), generator=gen,
                              device=device).tolist()
    still = int(round(w * traffic.still_left)) // 2 * 2
    seq = torch.empty((traffic.period + batch - 1, h * 3 // 2, w),
                      dtype=torch.uint8, device=device)
    for i in range(n):
        y, uv = seq[i, :h], seq[i, h:]
        y.copy_(ycan[i * dy:i * dy + h, i * dx:i * dx + w])
        r, c = (i * dy) // 2, 2 * ((i * dx) // 2)
        uv.copy_(uvcan[r:r + h // 2, c:c + w])
        if still:
            y[:, :still] = ycan[:h, :still]
            uv[:, :still] = uvcan[:h // 2, :still]
        if obj is not None:
            r0 = (start[0] + i * obj["step"][0]) % max(h - oh, 1)
            c0 = (start[1] + i * obj["step"][1]) % max(w - ow, 1)
            y[r0:r0 + oh, c0:c0 + ow] = otex
        if traffic.noise_block is not None:
            bh, bw = traffic.noise_block
            r0, c0 = (37 * i) % max(h - bh, 1), (101 * i) % max(w - bw, 1)
            y[r0:r0 + bh, c0:c0 + bw] = torch.randint(
                0, 256, (bh, bw), generator=gen, device=device, dtype=torch.uint8)
        if traffic.sensor_noise_sd:
            noise = torch.randn(seq[i].shape, generator=gen, device=device)
            seq[i] = (seq[i].to(torch.float32) + noise * traffic.sensor_noise_sd
                      ).round().clamp(0, 255).to(torch.uint8)
    for t in range(n, seq.shape[0]):
        seq[t] = seq[pingpong(t, n)]
    return seq

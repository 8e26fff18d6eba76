#!/usr/bin/env python3
"""Read the port's relay rate of two or more trees in turns on one CUDA card.

Each tree is a checkout of this repository (for example the parent commit,
unpacked with ``git archive`` into the git-ignored ``_checkout/``).  For each
configuration the script runs one process per tree and turn, in the order
A B ... B A, so that a drift of the host shows as a difference between the
two readings of the same tree.  Each process imports
``opencv_opencl_tpu_torch`` from its tree (``PYTHONPATH``), builds that
tree's kernels and native runtime, and runs ``apps.relay.run`` at 4K batch 4
on ``TestSource`` frames; the reading is the relay's own ``Shutdown`` rate:

    python3 scripts/torch_relay_turns.py _checkout/parent .

Configurations: histeq with gray chroma to the null sink (relay (a) of
``chip_smoke.py``), and CLAHE passthrough to ``rtp+raw://`` on loopback with
nothing listening (relay (e) without its receiver).  ``--frames`` sets the
frames a run (32).  The last line is one JSON object with every reading and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys

CONFIGS = {
    "histeq_null": ["--op=histeq", "--chroma=gray", "--sink=null"],
    "clahe_rtp_raw": ["--op=clahe", "--chroma=passthrough", "--sink=rtp+raw://"],
}
RUN = """
import sys
from opencv_opencl_tpu_torch.apps import relay
sys.exit(relay.run(sys.argv[1:]))
"""


def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def relay_fps(tree: str, extra: list[str], frames: int) -> float:
    """The Shutdown rate of one relay run of the package in ``tree``."""
    extra = [f"{a}127.0.0.1:{free_udp_port()}" if a.endswith("://") else a
             for a in extra]
    argv = ["--source=test", "--width=3840", "--height=2160", "--batch=4",
            f"--max-frames={frames}", "--status-interval=60"] + extra
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    res = subprocess.run([sys.executable, "-c", RUN, *argv], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=600)
    m = re.search(r"Shutdown: (\d+) frames emitted in [\d.]+s \(([\d.]+) fps\)",
                  res.stdout)
    if res.returncode != 0 or m is None:
        raise RuntimeError(f"{tree} {argv}: rc {res.returncode}\n"
                           f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    return float(m.group(2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    order = args.trees + args.trees[::-1]
    readings: dict[str, dict[str, list[float]]] = {}
    for name, extra in CONFIGS.items():
        readings[name] = {tree: [] for tree in args.trees}
        for tree in order:
            fps = relay_fps(tree, extra, args.frames)
            readings[name][tree].append(fps)
            print(f"turn {name} {tree}: {fps} fps [{card}]", flush=True)
    print(json.dumps({"card": card, "frames": args.frames, "relay_fps": readings}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

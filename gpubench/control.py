"""The readings that set the comparison's limits: for each seed, a short
window of a cell at its own size, then the compared numbers of the
program's kept steps and of the control, the reference computed with the
CLAHE blend in bfloat16 (the precision below the float32 that OpenCV's
CLAHE states) put in the program's place on the same steps.

    python -m gpubench.control --workload <cell> --seeds 1,2,3 --seconds 3 [--program-only]

One JSON line a seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gpubench import loop, run


def readings(workload: str, seed: int, seconds: float, control: bool, device=None,
             overrides=None) -> dict:
    _, _, traffic, system = run.prepare(workload, seed, device, overrides=overrides)
    system.warm_up(run.WARM_STEPS, traffic.in_flight + system.check_steps + 1)
    window = loop.run(system, seconds, traffic.in_flight, system.check_steps, seed)
    t0 = time.perf_counter()
    numbers = system.compare(window.kept, control)
    out = {"workload": workload, "seed": seed, "steps_compared": len(window.kept),
           "program": {k: v for k, v in numbers.items() if not k.startswith("control.")},
           "reference_s": time.perf_counter() - t0}
    if control:
        out["control"] = {k[len("control."):]: v for k, v in numbers.items()
                          if k.startswith("control.")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  not args.program_only)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's own copy of ``opencv_opencl_tpu/apps/_cli.py``.

Shared CLI plumbing: the reference's hand-rolled ``--key=value`` /
``--key value`` argv loops (``OpenCVequalHist.cpp:269-282``,
``clahe1frame.cpp:20-27``), as one reusable parser.

Unknown arguments warn and are ignored, exactly like the reference
(``clahe1frame.cpp:64``).
"""

from __future__ import annotations

import sys

__all__ = ["parse_kv_args", "get_arg", "install_sigterm_handler",
           "pop_device_flag", "resolve_device"]


def parse_kv_args(argv: list[str], keys: dict[str, type]) -> tuple[dict, list[str]]:
    """Parse ``--k=v`` and ``--k v`` style args.

    ``keys`` maps option name -> type (bool options are flags: present=True,
    and also accept ``--k=true/false``).  Returns (options, positionals).
    """
    opts: dict = {}
    pos: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            body = a[2:]
            if "=" in body:
                k, v = body.split("=", 1)
            else:
                k, v = body, None
            if k not in keys:
                print(f"Warning: ignoring unknown arg: {a}", file=sys.stderr)
                i += 1
                continue
            t = keys[k]
            if t is bool:
                if v is None:
                    opts[k] = True
                else:
                    opts[k] = v.lower() in ("1", "true", "yes", "on")
            else:
                if v is None:
                    i += 1
                    if i >= len(argv):
                        print(f"Warning: missing value for {a}", file=sys.stderr)
                        break
                    v = argv[i]
                try:
                    opts[k] = t(v)
                except (TypeError, ValueError):
                    print(f"Warning: bad value for --{k}: {v!r}", file=sys.stderr)
        else:
            pos.append(a)
        i += 1
    return opts, pos


def get_arg(opts: dict, key: str, default):
    return opts.get(key, default)


# The port's own two helpers: the apps that launch kernels run on the card
# unless ``--device=cpu`` names the plain versions (for tests).


def resolve_device(name: str):
    """``--device`` as a torch device, or None (with a line on stderr) when
    it names the card and there is none."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this app runs on the card "
              "(torch.cuda.is_available() is false); --device=cpu runs the "
              "kernels' plain versions for tests", file=sys.stderr)
        return None
    return device


def pop_device_flag(argv: list[str], default: str = "cuda") -> tuple[list[str], str]:
    """Take every ``--device=NAME`` out of ``argv`` (the last one wins), for
    the apps whose other arguments are positional; returns the rest of
    ``argv`` and the device name."""
    rest, name = [], default
    for a in argv:
        if a.startswith("--device="):
            name = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, name


def install_sigterm_handler() -> None:
    """Translate SIGTERM into KeyboardInterrupt so a systemd/k8s stop
    request drains the pipeline exactly like Ctrl-C (mp4 finalize, RTCP
    BYE, feeder drain) instead of killing it mid-frame.

    Installed process-globally at each app's entry; a no-op off the main
    thread and when a non-default handler is already present (embedding
    applications — including test harnesses that set their own — own
    their signal policy).
    """
    import signal

    def _raise(_signum, _frame):
        raise KeyboardInterrupt

    try:
        if signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
            signal.signal(signal.SIGTERM, _raise)
    except (ValueError, OSError):
        pass  # not the main thread / restricted environment

"""Rank functions of the tests that spawn gloo groups: one that injects a
failure on one rank (``tests/test_torch_sharded_encode.py``) and one that
runs the relay apps with their output captured
(``tests/test_torch_apps.py``).  They live apart from the test modules so
that the spawned ranks import torch and the port, not JAX."""

import contextlib
import importlib
import io

import torch.distributed as dist


def run_apps(mesh, device, calls: list[tuple[str, list[str]]]) -> list[tuple]:
    """On every rank: each ``(app, argv)`` of ``calls`` in turn, ``app`` a
    module name under ``opencv_opencl_tpu_torch.apps``; returns ``(return
    code, standard output, standard error)`` of each call."""
    del mesh, device  # the apps take both from their flags and the group
    results = []
    for app, argv in calls:
        module = importlib.import_module(f"opencv_opencl_tpu_torch.apps.{app}")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = module.run(list(argv))
        results.append((rc, out.getvalue(), err.getvalue()))
    return results


def fail_on_rank_1(mesh, device, argv: list[str]) -> dict:
    """On every rank: ``sharded_encode._agreed`` over a step that raises on
    rank 1 alone (what each rank raises), then the relay with ``argv``
    (``--mesh=2x1 --fused-encode`` with the intra encoder) whose step raises
    on rank 1 at its second batch after the warm-up (the relay's return
    code)."""
    from opencv_opencl_tpu_torch.apps import relay
    from opencv_opencl_tpu_torch.parallel import sharded_encode

    del mesh
    rank = dist.get_rank()

    def step():
        if rank == 1:
            raise ValueError("injected on rank 1")
        return "ran"

    try:
        agreed = sharded_encode._agreed(step, device)
    except Exception as e:  # noqa: BLE001 - the outcome is the result
        agreed = f"{type(e).__name__}: {e}"
    real = sharded_encode.build_enhance_levels_fn
    calls = []

    def build(*args, **kwargs):
        fn = real(*args, **kwargs)

        def failing(batch, qp):
            calls.append(len(batch))
            if rank == 1 and len(calls) == 3:
                raise RuntimeError("injected on rank 1")
            return fn(batch, qp)

        return failing

    sharded_encode.build_enhance_levels_fn = build
    try:
        rc = relay.run(list(argv))
    finally:
        sharded_encode.build_enhance_levels_fn = real
    return {"agreed": agreed, "rc": rc, "steps": len(calls)}

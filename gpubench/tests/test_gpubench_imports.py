"""Nothing the benchmark runs imports JAX or the JAX package, by top-level
name compared whole; the references import nothing of the port either."""

import os
import subprocess
import sys

import pytest

from gpubench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("modules,found", [
    (["opencv_opencl_tpu_torch", "opencv_opencl_tpu_torch.ops.clahe", "torch"], []),
    (["opencv_opencl_tpu.ops"], ["opencv_opencl_tpu"]),
    (["jaxlib.xla_client", "jaxtyping", "flaxen"], ["jaxlib"]),
    (["jax", "flax.linen"], ["flax", "jax"]),
])
def test_forbidden_names_are_compared_whole(modules, found):
    assert run.loaded_forbidden(modules) == found


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def _harness_modules() -> list[str]:
    mods = []
    for sub in ("", "systems", "reference", "metrics"):
        folder = os.path.join(ROOT, "gpubench", sub)
        for f in sorted(os.listdir(folder)):
            if f.endswith(".py") and f != "__init__.py" and "." not in f[:-3]:
                mods.append("gpubench." + (sub + "." if sub else "") + f[:-3])
    return mods


def test_the_harness_and_the_port_load_no_jax():
    code = "\n".join(f"import {m}" for m in _harness_modules())
    code += ("\nimport opencv_opencl_tpu_torch.models.enhancer"
             "\nimport opencv_opencl_tpu_torch.models.fused_encode"
             "\nimport opencv_opencl_tpu_torch.runtime.handoff")
    loaded = _modules_after(code)
    assert not loaded & set(run.FORBIDDEN)


def test_the_references_import_nothing_of_the_port():
    loaded = _modules_after("import gpubench.reference.clahe, gpubench.reference.gop, "
                            "gpubench.yardstick, gpubench.frames")
    assert not loaded & (set(run.FORBIDDEN) | {"opencv_opencl_tpu_torch"})


def test_a_run_fails_without_the_port(tmp_path):
    """In a directory with only BENCHMARK.json and gpubench/, no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                          "clahe_4k.streams32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_a_run_fails_without_a_card():
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                          "clahe_4k.streams32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout

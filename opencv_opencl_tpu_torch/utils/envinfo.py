"""Environment and device report for the port.

Counterpart of ``opencv_opencl_tpu/utils/envinfo.py``: one call that says
which PyTorch and CUDA this process has, which card it sees and at what
power limit, whether the kernel library is built, and whether the native
C++ runtime builds (and if not, why).
"""

from __future__ import annotations

import shutil
import subprocess

import torch

import opencv_opencl_tpu_torch
from opencv_opencl_tpu_torch import native
from opencv_opencl_tpu_torch.ops.cuda import _build

__all__ = ["nvidia_smi_name_power", "env_report", "print_env_report"]


def nvidia_smi_name_power() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` as
    it prints it (one line per card), or None without nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    if res.returncode != 0:
        return None
    return res.stdout.strip()


def env_report() -> dict:
    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    report = {
        "framework_version": opencv_opencl_tpu_torch.__version__,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "name_power_limit": nvidia_smi_name_power(),
        "kernels_built": _build.is_built(),
        "native_runtime": native.available(),
    }
    if not native.available():
        report["native_build_error"] = (native.build_error() or "")[:200]
    return report


def print_env_report() -> None:
    r = env_report()
    print("=== opencv_opencl_tpu_torch environment ===")
    print(f"Framework:      {r['framework_version']} (torch {r['torch_version']}, "
          f"CUDA {r['cuda_version'] or 'none'})")
    print(f"Devices:        {r['device_count']} "
          f"({', '.join(r['devices']) or 'no CUDA device'})")
    print(f"Power limit:    {r['name_power_limit'] or 'nvidia-smi unavailable'}")
    print(f"CUDA kernels:   {'built' if r['kernels_built'] else 'not built'}")
    print(f"Native runtime: {'available' if r['native_runtime'] else 'unavailable'}")


if __name__ == "__main__":
    print_env_report()

"""The port's wheel carries every file it needs that is not Python.

A file under ``opencv_opencl_tpu_torch/`` that is not a ``.py`` module (the
kernel sources in ``csrc/``, the native runtime's C++ and its build
script) reaches an installed package only where a
``[tool.setuptools.package-data]`` pattern of its package names it: the
patterns of a package ``p`` match paths relative to ``p``'s directory, one
``*`` a path segment (setuptools globs).  Without them the installed port
would find no ``framepipe.cpp``, and ``native.available()`` would be false.

Every app of the port with a ``main()`` is installed as a ``gpu-*`` console
script beside the JAX package's ``tpu-*`` one, and the metadata names
``torch`` as an optional extra while ``jax`` stays a dependency.
"""

import ast
import fnmatch
import os
import subprocess
import tomllib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "opencv_opencl_tpu_torch"


def _tracked_files() -> list[str]:
    """The port's files as git tracks them (a walk of the tree, without
    build outputs and caches, where git is not at hand)."""
    try:
        out = subprocess.run(["git", "ls-files", PORT], cwd=ROOT, check=True,
                             capture_output=True, text=True).stdout.split()
        if out:
            return out
    except (OSError, subprocess.CalledProcessError):
        pass
    found = []
    for top, dirs, files in os.walk(os.path.join(ROOT, PORT)):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        found += [os.path.relpath(os.path.join(top, f), ROOT).replace(os.sep, "/")
                  for f in files if not f.endswith(".pyc")]
    return found


def _matches(rel: str, pattern: str) -> bool:
    parts, pats = rel.split("/"), pattern.split("/")
    return len(parts) == len(pats) and all(
        fnmatch.fnmatchcase(p, q) for p, q in zip(parts, pats))


def _shipped(path: str, package_data: dict) -> bool:
    """Whether a pattern of a package that holds ``path`` names it."""
    parts = path.split("/")
    for depth in range(1, len(parts)):
        package_dir = os.path.join(ROOT, *parts[:depth])
        if not os.path.exists(os.path.join(package_dir, "__init__.py")):
            continue
        rel = "/".join(parts[depth:])
        if any(_matches(rel, pat) for pat in package_data.get(".".join(parts[:depth]), ())):
            return True
    return False


def test_every_file_of_the_port_that_is_not_python_is_package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        package_data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    others = [p for p in _tracked_files() if not p.endswith(".py")]
    assert "opencv_opencl_tpu_torch/native/framepipe.cpp" in others
    assert "opencv_opencl_tpu_torch/csrc/natural.cu" in others
    missing = [p for p in others if not _shipped(p, package_data)]
    assert not missing, f"not package data of any package: {missing}"


def test_the_glob_of_a_pattern_keeps_to_one_path_segment():
    assert _matches("csrc/natural.cu", "csrc/*.cu")
    assert not _matches("csrc/sub/natural.cu", "csrc/*.cu")
    assert not _matches("native/framepipe.cpp", "*.cpp")
    assert _shipped("opencv_opencl_tpu_torch/csrc/lut.cu",
                    {"opencv_opencl_tpu_torch": ["csrc/*.cu"]})
    assert not _shipped("opencv_opencl_tpu_torch/native/framepipe.cpp",
                        {"opencv_opencl_tpu_torch": ["csrc/*.cu"]})


def _pyproject() -> dict:
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def _apps_with_main(package: str) -> list[str]:
    """The modules of ``package``'s ``apps/`` that define a top-level
    ``main()``."""
    apps = os.path.join(ROOT, package, "apps")
    found = []
    for name in sorted(os.listdir(apps)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(apps, name)) as f:
            tree = ast.parse(f.read())
        if any(isinstance(n, ast.FunctionDef) and n.name == "main" for n in tree.body):
            found.append(name[:-3])
    return found


def test_every_port_app_with_a_main_is_a_gpu_script():
    scripts = _pyproject()["project"]["scripts"]
    apps = _apps_with_main(PORT)
    assert len(apps) == 11
    for app in apps:
        name = "gpu-" + app.replace("_", "-")
        assert scripts.get(name) == f"{PORT}.apps.{app}:main", name
        # beside the JAX package's script of the same app
        assert scripts.get("tpu-" + app.replace("_", "-")) == \
            f"opencv_opencl_tpu.apps.{app}:main"
    gpu = {k: v for k, v in scripts.items() if k.startswith("gpu-")}
    assert sorted(v.split(".")[-1].split(":")[0] for v in gpu.values()) == apps


def test_jax_stays_a_dependency_and_torch_is_an_extra():
    project = _pyproject()["project"]
    assert "jax" in project["dependencies"]
    assert project["optional-dependencies"]["torch"] == ["torch"]

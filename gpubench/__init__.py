"""The benchmark of the PyTorch and CUDA port (``opencv_opencl_tpu_torch``).

``python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``;
a configuration's ``system`` names the module under ``systems/`` that drives
the port's entry for it and its plain reference under ``reference/``.
"""

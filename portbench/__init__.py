"""The benchmark of dolfinx_materials_tpu_torch on an NVIDIA card.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything a cell, a configuration or a metric needs is found by name:

- ``workloads/<cell>.json``: the cell's traffic parameters and its limits;
- ``configs/<config>.json``: the configuration's sizes, source and cuts, and
  ``configs/<config>.py``: how the program builds it;
- ``reference/<config>.py``: the plain reference that judges its outputs;
- ``drivers/<kind>.py``: the general generator of a kind of traffic;
- ``metrics/<metric>.py``: one reader a metric, ``read(record)``.
"""

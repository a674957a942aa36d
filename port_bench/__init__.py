"""The benchmark of ``nerf_pytorch_paeng_tpu_torch`` on one NVIDIA H100.

Run one cell with ``python3 port_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Everything a
cell needs is found by name: ``configs/<config>.json``,
``workloads/<cell>.json`` and, for each per-layer metric of
``BENCHMARK.json``, ``metrics/<metric>.py``.
"""

"""The benchmark of ``fastdiffsr_tpu_torch`` on NVIDIA GPUs.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Cells, configurations, traffic mixes and per-layer metrics are
files found by name under ``workloads/``, ``configs/``, ``traffic/`` and
``metrics/``; the runner a mix names (``runners/``) drives them with what
``harness/`` provides, and ``reference/`` checks them.
"""

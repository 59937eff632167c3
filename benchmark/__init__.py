"""The benchmark of ``rtgs_tpu_torch`` on one NVIDIA H100: one command runs
one cell once (``python3 -m benchmark.run --workload <cell> ...``); see
``README.md``. Importing this package imports neither torch nor the port."""

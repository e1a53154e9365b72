"""The benchmark of srslte_tpu_torch (see BENCHMARK.json at the repository
root and `run.py`)."""

"""The benchmark of mla_tpu_torch (see run.py and BENCHMARK.json)."""

"""Benchmark of pasta_tpu_torch on NVIDIA GPUs: `python3 -m benchmark.run`."""

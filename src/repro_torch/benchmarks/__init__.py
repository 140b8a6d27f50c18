"""Benchmark scripts of the port, run as ``python -m repro_torch.benchmarks.<name>``."""

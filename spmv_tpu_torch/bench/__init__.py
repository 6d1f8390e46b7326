"""Benchmarks of the PyTorch port: ``bench.runner`` and the weak-scaling
sweep ``bench.scaling``, the counterparts of ``spmv_tpu/bench/``."""

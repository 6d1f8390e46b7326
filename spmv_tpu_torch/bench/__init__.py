"""Benchmarks of the PyTorch port: ``bench.runner`` and the weak-scaling
sweep ``bench.scaling``, the counterparts of ``spmv_tpu/bench/``, and the
driver benchmark ``bench.suite``, the counterpart of the root ``bench.py``."""

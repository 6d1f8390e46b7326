"""Benchmarks of the PyTorch port: ``bench.runner`` (the counterpart of
``spmv_tpu/bench/``; its weak-scaling sweep, ``scaling.py``, comes with the
distribution slice)."""

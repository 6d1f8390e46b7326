"""The benchmark of ``spmv_tpu_torch``: one cell of ``BENCHMARK.json`` per
run, ``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. It measures the port (the ``_torch`` package) alone and
never imports JAX or the JAX package.
"""

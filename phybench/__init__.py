"""phybench: the benchmark of fun_ofdm_tpu_torch (see phybench/run.py)."""

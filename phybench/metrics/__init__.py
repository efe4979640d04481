"""Per-layer metric readers, one file per metric name (see phybench/run.py)."""

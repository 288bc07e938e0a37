"""The benchmark of simka_tpu_torch on one NVIDIA H100 (``run.py``)."""

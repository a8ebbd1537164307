"""The benchmark of condmdi_tpu_torch on one NVIDIA H100: see run.py and PERF.md."""

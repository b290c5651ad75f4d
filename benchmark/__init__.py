"""The benchmark of ``samplernn_pase_tpu_torch`` on an NVIDIA H100: the
harness, its drivers, traffic generator and per-layer metric readers, the
yardstick's arithmetic and the plain reference that decides ``correct``.
``python -m benchmark.run --help`` says how to run a cell."""

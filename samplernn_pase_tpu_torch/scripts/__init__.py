"""Measurement entry points of the port, run as
``python -m samplernn_pase_tpu_torch.scripts.<name>``."""

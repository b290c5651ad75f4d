"""Training: the optimizer and the TBPTT step functions, mirroring
``samplernn_pase_tpu.train``."""

"""Training: the optimizer, the TBPTT step functions, the Trainer loop
with its plugins, checkpoints and metrics, mirroring
``samplernn_pase_tpu.train``."""

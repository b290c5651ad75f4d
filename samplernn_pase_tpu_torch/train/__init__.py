"""Training: the optimizer, the TBPTT step functions, the Trainer loop
with its plugins, checkpoints and metrics, and joint PASE + SampleRNN
training, mirroring ``samplernn_pase_tpu.train``."""

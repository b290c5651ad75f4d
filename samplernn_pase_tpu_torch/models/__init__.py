"""SampleRNN model modules and the PASE encoder in plain PyTorch,
mirroring ``samplernn_pase_tpu.models`` function for function."""

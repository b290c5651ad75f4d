"""Elementwise codecs, weight init and weight norm, framing and the TBPTT
batcher, and audio I/O; ``kernels`` holds the hand-written CUDA kernels
and their plain PyTorch versions."""

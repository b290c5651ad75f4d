"""The plain reference of the benchmark: float32 PyTorch and numpy.

Nothing here imports JAX, the JAX package or the PyTorch port.  The
reference takes the inputs the harness made (weights, levels, rows,
keys, wav files) and works out again whatever the port derives from them.
"""

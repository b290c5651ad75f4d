"""The repo's four ``examples/`` as modules of the port, each run as
``python -m samplernn_pase_tpu_torch.examples.<name> [--device cpu]
[out]``: ``train_and_generate``, ``tts_speakers``, ``serving_stream`` and
``pool_serving``.  They run on the card by default; ``--device cpu``
runs a smaller model on the CPU."""

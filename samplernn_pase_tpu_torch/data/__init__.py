"""Data pipeline: corpus loading and TBPTT stream batching, mirroring
``samplernn_pase_tpu.data``."""

from samplernn_pase_tpu_torch.data.dataset import (  # noqa: F401
    WavCorpus,
    device_put_batch,
    synthetic_corpus,
)

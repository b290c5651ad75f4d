"""Entry point of the flagship's teacher-forced forward pass plus NLL, as
``__graft_entry__.entry`` of the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import samplernn


FLAGSHIP = SampleRNNConfig(frame_sizes=(16, 4), dim=1024, embed_dim=256)


def entry(device=None):
    """Returns (fn, example_args): fn(params, state, inputs, targets) ->
    (nll_bits, new_state) on the flagship at B=8, T=1024, with random
    weights from seed 0, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cfg = FLAGSHIP
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    b, t = 8, 1024
    state = samplernn.initial_state(params, cfg, b)
    rng = np.random.default_rng(0)
    inputs = torch.from_numpy(rng.integers(
        0, cfg.q_levels, (b, cfg.lookback + t), np.int32)).to(dev)
    targets = inputs[:, cfg.lookback:]

    def fn(params, state, inputs, targets):
        return samplernn.loss_fn(params, cfg, inputs, targets, state)

    return fn, (params, state, inputs, targets)

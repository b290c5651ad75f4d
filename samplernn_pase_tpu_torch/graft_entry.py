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


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 600.0) -> str:
    """The reference's ``dryrun_multichip`` over ``n_devices`` spawned
    ranks (gloo; on the CPU unless ``device`` names a card, which every
    rank then shares): on a (n/2, 2) (data, model) mesh when n >= 4 is
    even, else (n, 1), the full train step (value and grad, the gradient
    sum over ``data``, clipping, Adam) with the batch and hiddens split
    over ``data`` and the sample MLP over ``model``; greedy generation;
    a conditioned speaker LSTM train step and conditioned generation; and
    the serving pool's lifecycle with sampled lanes at an unaligned chunk
    on an (n,) ``data`` mesh.  Each must equal the unsharded run (1e-5,
    or bit for bit for levels) on every rank.  Prints and returns the
    reference's summary line; raises if a rank fails or the ranks do not
    finish within ``timeout`` seconds."""
    from samplernn_pase_tpu_torch.parallel.dryrun import dryrun_rank
    from samplernn_pase_tpu_torch.parallel.launch import run_ranks

    dev = None if device is None else str(torch.device(device))
    line = run_ranks(dryrun_rank, n_devices, (dev,), device=dev,
                     timeout=timeout)[0]
    print(line)
    return line

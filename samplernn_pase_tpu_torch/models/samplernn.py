"""SampleRNN container: K frame tiers plus the sample-level MLP, as
``samplernn_pase_tpu.models.samplernn``: parameters and state, reset
masking, the teacher-forced ``forward`` and the NLL.

``frame_sizes`` is ordered bottom -> top; tier k steps over
``prod(frame_sizes[:k+1])`` samples; ``lookback = prod(frame_sizes)``.  A
training chunk supplies ``lookback`` samples of left context plus ``T``
targets with ``T % lookback == 0``.  External conditioning arrives at
``cond_rate`` samples per frame and is gathered to each tier's frame rate
(nearest previous frame).

Training RNN route (``cfg.pallas_train_rnn``, as the reference's
``forward``): ``True`` or ``"auto"`` on CUDA tensors runs each tier through
the whole-sequence kernels (``ops/kernels/rnn_train.py``: K4 for GRU, K5
for LSTM; its docstring gives the eligibility on the H100: ``dim % 8 ==
0`` and the serial kernels' blocks co-resident, dim <= 1,056 in float32
on 132 SMs), and a tier the kernel cannot take raises ``ValueError`` with
the reason.  ``False`` is the reference's own scan route, the autograd
``rnn_scan``, everywhere, and the only route that scans on the card.  On
CPU tensors ``True`` runs the kernels' plain versions; ``"auto"`` scans.

Under a profiler ``forward`` records a span ``samplernn.tier`` around each
tier's pass (``utils/profiling.py``), with attrs ``tier`` (k), ``cell``
(``rnn_type``), ``steps`` (frames in the chunk), ``layers`` (``n_rnn``)
and ``route`` ("kernel" or "scan").
"""

from __future__ import annotations

import math
import sys

import torch
import torch.utils.checkpoint

from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import frame_rnn, sample_mlp
from samplernn_pase_tpu_torch.ops import init as winit
from samplernn_pase_tpu_torch.ops.framing import frame_signal
from samplernn_pase_tpu_torch.ops.kernels import rnn_train
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype
from samplernn_pase_tpu_torch.ops.mulaw import levels_to_float
from samplernn_pase_tpu_torch.parallel.mesh import (
    all_reduce, axis_group, axis_size, model_group)
from samplernn_pase_tpu_torch.tree import tree_map
from samplernn_pase_tpu_torch.utils import profiling

Params = dict
State = tuple


def init_params(gen: torch.Generator, cfg: SampleRNNConfig,
                device=None) -> Params:
    """Random float32 parameters drawn from ``gen`` (a CPU generator, so
    a seed gives the same weights everywhere), moved to ``device``: the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)
    tiers = [
        frame_rnn.init_frame_tier(
            gen, span=cfg.tier_spans[k], frame_size=cfg.frame_sizes[k],
            dim=cfg.dim, n_rnn=cfg.n_rnn, rnn_type=cfg.rnn_type,
            cond_dim=cfg.cond_dim, learn_h0=cfg.learn_h0,
            use_weight_norm=cfg.weight_norm)
        for k in range(cfg.n_tiers)]
    # the MLP hidden width equals dim: the bottom tier's conditioning
    # rows add onto its first hidden layer
    mlp = sample_mlp.init_sample_mlp(
        gen, cfg.frame_sizes[0], cfg.q_levels, cfg.embed_dim, cfg.dim,
        use_weight_norm=cfg.weight_norm)
    params = {"tiers": tiers, "mlp": mlp}
    if cfg.n_speakers:
        if not cfg.cond_dim or not cfg.cond_rate:
            raise ValueError("n_speakers requires cond_dim and cond_rate")
        params["speaker"] = winit.uniform(
            gen, (cfg.n_speakers, cfg.cond_dim), scale=0.1)
    return tree_map(lambda t: t.to(device), params)


def initial_state(params: Params, cfg: SampleRNNConfig, batch: int) -> State:
    device = params["mlp"]["b_out"].device
    return tuple(
        frame_rnn.tier_initial_state(
            params["tiers"][k], batch, cfg.dim, cfg.n_rnn, cfg.rnn_type,
            device)
        for k in range(cfg.n_tiers))


def slice_state_lane(state: State, lane: int) -> State:
    """Lane ``lane`` of a batched state, as a batch-1 state (the batch is
    axis -2 in every tier state layout)."""
    return tuple(h[..., lane:lane + 1, :] for h in state)


def reset_state(params: Params, cfg: SampleRNNConfig, state: State,
                resets) -> State:
    """Reset (to the learned h0, or zeros) the state of lanes whose flag
    is set.  resets: bool/int [B]."""
    init = initial_state(params, cfg, resets.shape[0])
    out = []
    for s, s0 in zip(state, init):
        shape = [1] * s.dim()
        shape[-2] = resets.shape[0]
        mask = resets.to(s.dtype).reshape(shape)
        out.append(s0 * mask + s * (1.0 - mask))
    return tuple(out)


_RNN_PATH_LOGGED: set = set()


def _log_rnn_path(k: int, use_kernel: bool, reason: str):
    """One line per tier and outcome: which training RNN route a tier
    takes (the sequence kernel or the scan), so a measurement names the
    path it measured."""
    key = (k, use_kernel, reason)
    if key in _RNN_PATH_LOGGED:
        return
    _RNN_PATH_LOGGED.add(key)
    what = "sequence kernel" if use_kernel else f"scan ({reason})"
    print(f"[samplernn] tier {k} training RNN path: {what}", file=sys.stderr)


def _rnn_route(cfg: SampleRNNConfig, k: int, device) -> bool:
    """Whether tier k's training RNN runs through the sequence kernels.
    On CUDA under ``True``/``"auto"`` a tier the kernel cannot take
    raises: only ``pallas_train_rnn=False`` scans on the card."""
    flag = cfg.pallas_train_rnn
    on_cuda = device.type == "cuda"
    enabled = flag is True or (flag == "auto" and on_cuda)
    reason = ""
    if not enabled:
        reason = ("pallas_train_rnn=False" if flag is False
                  else "auto: not on a CUDA device")
    elif on_cuda:
        why = rnn_train.kernel_scope_error(cfg.rnn_type, cfg.dim,
                                           cfg.compute_dtype, device)
        if why:
            raise ValueError(
                f"pallas_train_rnn={flag!r} on CUDA: tier {k}: {why}; set "
                "pallas_train_rnn=False to scan")
    _log_rnn_path(k, enabled, reason)
    return enabled


def cond_index(n_frames: int, span: int, cond_rate: int, device=None):
    """Frame j of a tier with step ``span`` reads cond frame
    (j*span)//rate."""
    return (torch.arange(n_frames, device=device) * span) // cond_rate


def _tier_ext_cond(cond, n_frames: int, span: int, cond_rate: int):
    if cond is None:
        return None
    idx = cond_index(n_frames, span, cond_rate, cond.device).clamp(
        0, cond.shape[1] - 1)
    return cond[:, idx]


def speaker_cond(params: Params, cfg: SampleRNNConfig, speakers, cond,
                 n_cond_frames: int):
    """Fold per-lane speaker ids [B] into the conditioning stream: the
    learned embedding is broadcast over time and added onto (or used as)
    the external conditioning."""
    spk = params["speaker"][speakers.long()]            # [B, cond_dim]
    if cond is None:
        return spk[:, None, :].expand(spk.shape[0], n_cond_frames,
                                      spk.shape[1])
    return cond + spk[:, None, :]


def forward(params: Params, cfg: SampleRNNConfig, inputs, state: State,
            cond=None, speakers=None, mesh=None):
    """Teacher-forced forward pass.

    inputs [B, lookback + T] int levels; cond [B, T // cond_rate,
    cond_dim] or None; speakers [B] int ids or None (needs n_speakers).
    Returns (logits [B, T, q_levels] float32, new_state).  Under a
    ``mesh`` (``parallel.mesh``) every input is this rank's block of the
    batch; with a ``model`` axis > 1 ``params`` hold this rank's MLP
    shards (``shard_params``)."""
    dt = torch_dtype(cfg.compute_dtype)
    lookback = cfg.lookback
    t = inputs.shape[1] - lookback
    if t % lookback:
        raise ValueError(f"T={t} must be a multiple of lookback={lookback}")
    if speakers is not None:
        cond = speaker_cond(params, cfg, speakers, cond,
                            max(t // cfg.cond_rate, 1))
    x_float = levels_to_float(inputs, cfg.q_levels)
    upper = None
    new_states = [None] * cfg.n_tiers
    for k in range(cfg.n_tiers - 1, -1, -1):
        span = cfg.tier_spans[k]
        frames = frame_signal(
            x_float[:, lookback - span: lookback - span + t], span)
        ext = _tier_ext_cond(cond, t // span, span, cfg.cond_rate)
        use_kernel = _rnn_route(cfg, k, inputs.device)

        def apply_fn(p, fr, up, ex, st, _fs=cfg.frame_sizes[k],
                     _use=use_kernel):
            return frame_rnn.tier_apply(
                p, fr, up, ex, st, frame_size=_fs, rnn_type=cfg.rnn_type,
                compute_dtype=dt, use_kernel=_use)

        with profiling.span("samplernn.tier", tier=k, cell=cfg.rnn_type,
                            steps=t // span, layers=cfg.n_rnn,
                            route="kernel" if use_kernel else "scan"):
            if cfg.remat:
                # recompute the tier's activations in the backward pass
                upper, new_states[k] = torch.utils.checkpoint.checkpoint(
                    apply_fn, params["tiers"][k], frames, upper, ext,
                    state[k], use_reentrant=False)
            else:
                upper, new_states[k] = apply_fn(params["tiers"][k], frames,
                                                upper, ext, state[k])
    f1 = cfg.frame_sizes[0]
    mlp_samples = inputs[:, lookback - f1: lookback + t - 1]
    logits = sample_mlp.mlp_apply(params["mlp"], mlp_samples, upper, f1, dt,
                                  model_group(mesh))
    return logits, tuple(new_states)


def nll_bits(logits, targets, valid=None, mesh=None):
    """Cross-entropy in bits per sample: logsumexp minus the picked logit.

    ``valid`` (int [B] or None): the number of real targets per lane;
    positions at or past it are padding and masked out (sum over real
    positions / their count).  An all-padding batch gives 0.

    Under a ``mesh`` the batch is this rank's block: its sum is divided by
    the count over the whole ``data`` axis, so that the ranks' losses add
    up to the global mean (ragged tails weigh as they do unsharded) and
    their gradients sum to its gradient.  The value returned is this
    rank's part; ``global_nll`` sums the parts."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    nats = lse - picked                                   # [B, T]
    group = axis_group(mesh, "data")
    if valid is None:
        if group is None:
            return nats.mean() / math.log(2.0)
        count = nats.numel() * axis_size(mesh, "data")
        return (nats.sum() / count) / math.log(2.0)
    mask = (torch.arange(nats.shape[-1], device=nats.device)[None, :]
            < valid.to(nats.device)[:, None]).to(nats.dtype)
    count = all_reduce(mask.sum(), group)
    return ((nats * mask).sum() / count.clamp(min=1.0)) / math.log(2.0)


def global_nll(nll, mesh=None):
    """The whole batch's NLL from the ranks' parts (``nll_bits``), on
    every rank, without autograd history."""
    return all_reduce(nll.detach(), axis_group(mesh, "data"))


def loss_fn(params: Params, cfg: SampleRNNConfig, batch_inputs,
            batch_targets, state: State, cond=None, speakers=None,
            valid=None, mesh=None):
    logits, new_state = forward(params, cfg, batch_inputs, state, cond,
                                speakers, mesh)
    return nll_bits(logits, batch_targets, valid, mesh), new_state

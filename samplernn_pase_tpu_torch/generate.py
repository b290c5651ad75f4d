"""Batched autoregressive generation, the counterpart of
``samplernn_pase_tpu.generate`` (unconditioned).

Routes, chosen by ``use_kernels``:

* kernels (``True`` or ``"frame"``, or ``None`` on CUDA tensors):
  ``ops/kernels/megagen.run``, the counterpart of the megakernel.  On the
  H100 it is itself a host loop whose bottom frames run the counterpart
  of ``fused_tier_frame_decode``, so ``"frame"`` (the reference's
  ``use_pallas="frame"``) takes the same loop;
* plain (``False``, or ``None`` on CPU tensors): the recursion below on
  the plain model modules (``tier_step``, ``mlp_step``), the logic of the
  reference's ``_xla_generate``.

The kernel route takes GRU or LSTM tiers with n_rnn=1 at 2 or 3 tiers
and frame_sizes[0] >= 2; n_rnn stacks, other tier counts and f1=1 raise
``NotImplementedError`` there (the plain route runs them).
On CPU tensors the kernel route runs the kernels' plain versions, which
is how the tests hold it against the JAX package.  Its weights in kernel
form (``prepare_weights``) belong to the model, not to a request:
``make_generator`` prepares them once, and ``generate_levels`` takes
them as ``kernel_weights``.

Sampling is Gumbel-max, ``argmax(logits + temperature * g)``, on every
route, with ``g`` from the Philox stream of ``ops/kernels/noise.py``
keyed by ``seed`` and counted by (lane, absolute sample position, level);
``noise_pos0`` is the absolute position of the call's first sample, so
a generation split over calls with ``return_state`` draws the same noise
as one call.  ``temperature`` None or 0 is greedy.
"""

from __future__ import annotations

import numpy as np
import torch

from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import frame_rnn, sample_mlp, samplernn
from samplernn_pase_tpu_torch.ops.kernels import megagen
from samplernn_pase_tpu_torch.ops.kernels.noise import gumbel_block
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype
from samplernn_pase_tpu_torch.ops.mulaw import (
    levels_to_float, linear_dequantize, mu_law_decode, quantize_zero)
from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map

_CONDITIONED = ("conditioned generation (cond, speakers, lane_keys, "
                "cond_pos0) comes with ROADMAP.md B4")


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def kernel_scope_error(cfg: SampleRNNConfig) -> str | None:
    """Why the decode kernels cannot run ``cfg``, or None if they can."""
    if cfg.rnn_type not in ("gru", "lstm"):
        return f"the decode kernels take GRU or LSTM tiers, not " \
               f"{cfg.rnn_type}"
    if cfg.n_rnn != 1:
        return "the decode kernels take n_rnn=1; n_rnn stacks come with " \
               "ROADMAP.md B4"
    if cfg.n_tiers not in (2, 3):
        return f"the decode kernels take 2 or 3 tiers, not {cfg.n_tiers}; " \
               "other tier counts come with ROADMAP.md B4"
    if cfg.frame_sizes[0] < 2:
        return "the decode kernels need frame_sizes[0] >= 2; f1=1 comes " \
               "with ROADMAP.md B4"
    return None


# ------------------------------------------------------- plain route --

def _decode_tier(params, cfg, k, hist, states, pos, upper_vec, out):
    """Decode one tier-k frame's worth of samples, recursively, on the
    plain model modules.

    hist [B, lookback] rolling history; states: per-tier states; pos:
    index of the frame's first sample within this call; upper_vec [B, dim]
    conditioning row from the parent tier (None at the top).  ``out``
    holds the noise settings, the emitted blocks and, for rescoring, the
    forced samples.  Returns (hist, states)."""
    f1 = cfg.frame_sizes[0]
    span = cfg.tier_spans[k]
    temp = out["temperature"]
    frame = levels_to_float(hist[:, -span:], cfg.q_levels)
    cond_rows, new_state = frame_rnn.tier_step(
        params["tiers"][k], frame, upper_vec, None, states[k],
        frame_size=cfg.frame_sizes[k], rnn_type=cfg.rnn_type,
        compute_dtype=torch_dtype(cfg.compute_dtype))
    states = states[:k] + (new_state,) + states[k + 1:]
    if k == 0:
        g = None
        if temp:
            g = gumbel_block(out["seed"], hist.shape[0],
                             out["noise_pos0"] + pos, f1, cfg.q_levels,
                             hist.device)
        forced = out.get("forced")
        samples = []
        for i in range(f1):
            logits = sample_mlp.mlp_step(
                params["mlp"], hist[:, -f1:], cond_rows[:, i],
                torch_dtype(cfg.compute_dtype))
            scores = logits if g is None else logits + temp * g[i]
            sample = torch.argmax(scores, dim=-1).to(torch.int32)
            samples.append(sample)
            if forced is not None:
                sample = forced[:, pos + i]
            hist = torch.cat([hist[:, 1:], sample[:, None]], dim=1)
        out["blocks"].append(torch.stack(samples, dim=1))
        return hist, states
    child_span = cfg.tier_spans[k - 1]
    for j in range(cfg.frame_sizes[k]):
        hist, states = _decode_tier(params, cfg, k - 1, hist, states,
                                    pos + j * child_span, cond_rows[:, j],
                                    out)
    return hist, states


def _generate_plain(params, cfg, hist, states, n_steps, temperature, seed,
                    noise_pos0, forced=None):
    out = {"temperature": temperature, "seed": seed,
           "noise_pos0": noise_pos0, "blocks": [], "forced": forced}
    top = cfg.n_tiers - 1
    for step in range(n_steps):
        hist, states = _decode_tier(params, cfg, top, hist, states,
                                    step * cfg.lookback, None, out)
    levels = torch.cat(out["blocks"], dim=1)
    return levels, states, hist


# ------------------------------------------------------ kernel route --

def prepare_weights(params, cfg: SampleRNNConfig, device=None) -> dict:
    """The kernel route's form of ``params`` on ``device``: weight norm
    resolved, matrices cast to the compute dtype, the embedding folded
    into the MLP's first layer (f1 launches of K2).  Prepare once per
    model and pass the result to every request as ``kernel_weights``."""
    why = kernel_scope_error(cfg)
    if why:
        raise NotImplementedError(why)
    params = tree_map(lambda t: t.to(resolve_device(device)), params)
    return megagen.prepare(params["tiers"], params["mlp"], cfg.compute_dtype)


def _generate_kernels(weights, cfg, length, temperature, seed, hist,
                      initial_states, noise_pos0):
    """Whole generation through ``megagen.run``, in one call.

    Chunking rule on the H100: none.  The TPU chunks to bound the
    megakernel's VMEM output buffer (``_vmem_cap``); here the only
    per-length allocation is the int32 level buffer (8 MB at B=128,
    16,000 samples) and the noise is drawn in K1, so one call covers the
    whole length.  A caller that wants shorter calls splits the length
    itself and carries ``return_state`` and ``noise_pos0``."""
    n_top = -(-length // cfg.lookback)
    levels, states = megagen.run(
        weights, hist, tuple(initial_states), temperature or 0.0, n_top,
        cfg.q_levels, seed=seed, pos0=noise_pos0)
    return levels, states, levels[:, -cfg.lookback:]


def _route(use_kernels, device, cfg):
    if use_kernels is None:
        use_kernels = device.type == "cuda"
    if use_kernels is False:
        return "plain"
    if use_kernels not in (True, "frame"):
        raise ValueError(f"use_kernels={use_kernels!r}")
    why = kernel_scope_error(cfg)
    if why:
        raise NotImplementedError(why)
    return "kernels"


def generate_levels(params, cfg: SampleRNNConfig, n_seqs: int, length: int,
                    temperature: float | None = 1.0, seed: int = 0,
                    cond=None, initial_states=None, hist=None,
                    use_kernels: bool | str | None = None, speakers=None,
                    return_state: bool = False, cond_pos0=0, lane_keys=None,
                    noise_pos0: int = 0, device=None, kernel_weights=None):
    """Generate quantized levels [n_seqs, length] int32.

    ``length`` is rounded up to a multiple of lookback and trimmed.
    ``temperature`` None or 0 = greedy.  ``seed``/``noise_pos0`` key the
    sampling noise (see the module docstring).  ``initial_states`` (per
    tier [n_rnn, B, dim]) and ``hist`` ([B, lookback] int32) continue a
    stream (LSTM tiers [n_rnn, 2, B, dim]); ``return_state`` returns
    (levels, states, hist) to carry on.
    ``use_kernels``: None = kernels on CUDA, plain on CPU; True or
    "frame" = kernels; False = plain.  ``device``: where to run (default
    CUDA, which must be present); the parameters are moved there.
    ``kernel_weights``: ``prepare_weights(params, cfg, device)``, else the
    kernel route prepares them for this call.  Conditioned decode is not
    in this port yet and raises ``NotImplementedError``."""
    if cond is not None or speakers is not None or lane_keys is not None \
            or (not isinstance(cond_pos0, (int, np.integer))
                or cond_pos0 != 0):
        raise NotImplementedError(_CONDITIONED)
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    if not temperature:
        temperature = None
    lookback = cfg.lookback
    if initial_states is None:
        initial_states = samplernn.initial_state(params, cfg, n_seqs)
    states = tuple(s.to(dev) for s in initial_states)
    if hist is None:
        hist = torch.full((n_seqs, lookback), quantize_zero(cfg.q_levels),
                          dtype=torch.int32, device=dev)
    hist = hist.to(device=dev, dtype=torch.int32)
    if length <= 0:
        levels = torch.zeros((n_seqs, 0), dtype=torch.int32, device=dev)
        return (levels, states, hist) if return_state else levels
    if _route(use_kernels, dev, cfg) == "kernels":
        if kernel_weights is None:
            kernel_weights = prepare_weights(params, cfg, dev)
        levels, states, hist = _generate_kernels(
            kernel_weights, cfg, length, temperature, seed, hist, states,
            noise_pos0)
    else:
        levels, states, hist = _generate_plain(
            params, cfg, hist, states, -(-length // lookback), temperature,
            seed, noise_pos0)
    # like the reference, a trimmed call's carried state and hist cover
    # its whole top frames
    levels = levels[:, :length]
    if return_state:
        return levels, states, hist
    return levels


def rescore(params, cfg: SampleRNNConfig, levels, temperature=None,
            seed: int = 0, noise_pos0: int = 0, initial_states=None,
            hist=None) -> float:
    """Share of ``levels`` [B, T] (T a multiple of lookback) that the plain
    per-step modules pick again when fed the emitted history: at every
    position, ``argmax(logits + temperature * g)`` with the same Philox
    noise.  The bf16 check of a kernel route, which cannot be bitwise."""
    b, t = levels.shape
    if t % cfg.lookback:
        raise ValueError(f"T={t} is not a multiple of {cfg.lookback}")
    dev = levels.device
    params = tree_map(lambda t: t.to(dev), params)
    if initial_states is None:
        initial_states = samplernn.initial_state(params, cfg, b)
    if hist is None:
        hist = torch.full((b, cfg.lookback), quantize_zero(cfg.q_levels),
                          dtype=torch.int32, device=dev)
    with torch.no_grad():
        picked, _, _ = _generate_plain(
            params, cfg, hist, tuple(initial_states), t // cfg.lookback,
            temperature or None, seed, noise_pos0,
            forced=levels.to(torch.int32))
    return float((picked == levels).to(torch.float32).mean())


def decode_waveform(levels, cfg: SampleRNNConfig) -> torch.Tensor:
    """Quantized levels -> float waveform in [-1, 1] with the model's
    codec."""
    if cfg.codec == "linear":
        return linear_dequantize(levels, cfg.q_levels)
    return mu_law_decode(levels, cfg.q_levels)


def generate(params, cfg: SampleRNNConfig, n_seqs: int, length: int,
             temperature: float | None = 1.0, seed: int = 0, cond=None,
             use_kernels: bool | str | None = None, speakers=None,
             device=None) -> torch.Tensor:
    """Generate float waveforms [n_seqs, length] in [-1, 1]."""
    levels = generate_levels(params, cfg, n_seqs, length, temperature, seed,
                             cond, use_kernels=use_kernels,
                             speakers=speakers, device=device)
    return decode_waveform(levels, cfg)


def make_generator(cfg: SampleRNNConfig, n_seqs: int, length: int,
                   temperature: float | None = 1.0,
                   conditioned: bool = False,
                   use_kernels: bool | str | None = None, device=None):
    """A generator fn (params, seed) -> levels [n_seqs, length].

    On the kernel route it prepares ``params``' kernel weights once and
    keeps them while the same tensors, unmodified, come back; new or
    modified parameters are prepared again."""
    if conditioned:
        raise NotImplementedError(_CONDITIONED)
    dev = resolve_device(device)
    kernels = _route(use_kernels, dev, cfg) == "kernels"
    cache = {}

    def fn(params, seed=0):
        weights = None
        if kernels:
            key = tuple((id(t), t._version) for t in tree_leaves(params))
            if cache.get("key") != key:
                cache.clear()
                cache.update(key=key, params=params,
                             weights=prepare_weights(params, cfg, dev))
            weights = cache["weights"]
        return generate_levels(params, cfg, n_seqs, length, temperature,
                               seed, use_kernels=use_kernels, device=dev,
                               kernel_weights=weights)
    return fn

"""Batched autoregressive generation and streaming, the counterpart of
``samplernn_pase_tpu.generate``.

Routes, chosen by ``use_kernels``:

* kernels (``True`` or ``"frame"``, or ``None`` on CUDA tensors):
  ``ops/kernels/megagen.run``, the counterpart of the megakernel.  On the
  H100 it is itself a host loop whose bottom frames run the counterpart
  of ``fused_tier_frame_decode``, so ``"frame"`` (the reference's
  ``use_pallas="frame"``) takes the same loop;
* plain (``False``, or ``None`` on CPU tensors): the recursion below on
  the plain model modules (``tier_step``, ``mlp_step``), the logic of the
  reference's ``_xla_generate``.

The kernel route takes every configuration the reference decodes: GRU
or LSTM tiers of any ``n_rnn``, any tier count (a 1-tier model has no
``upper``), any f1 (f1 = 1 included), conditioned or not; its loop is the
counterpart of both the reference's megakernel and its per-frame route.
On CPU tensors the kernel route runs the kernels' plain versions,
which is how the tests hold it against the JAX package.  Its weights in
kernel form (``prepare_weights``) belong to the model, not to a request:
``make_generator`` and the streaming classes prepare them once, and
``generate_levels`` takes them as ``kernel_weights``.

Conditioning (``cond`` [B, F, cond_dim], row r covering samples
[r*cond_rate, (r+1)*cond_rate), clamped to its last row past its end;
``speakers`` folded in) is read from ``cond_pos0``, an int or a [B]
tensor of per-lane stream positions.  On the kernel route each lane's
rows are gathered from its own origin, projected once per call per tier
through K2 and added by K2's epilogue with a per-lane two-row select (the
megakernel's ``cond_phase``), so chunk lengths need not align to
``cond_rate``.

Sampling is Gumbel-max, ``argmax(logits + temperature * g)``, on every
route, with ``g`` from the Philox stream of ``ops/kernels/noise.py``:
keyed by ``seed`` and counted by (lane, position, level), or, with
``lane_keys`` [B, 2], keyed by each lane's own key and counted by
(position, level) only, so a lane's stream does not depend on its batch
(the reference's per-lane ``lane_keys`` semantics).  ``noise_pos0`` (an
int or a [B] tensor) is the position of the call's first sample, so a
generation split over calls with ``return_state`` draws the same noise as
one call.  ``temperature`` None or 0 is greedy.
"""

from __future__ import annotations

import numpy as np
import torch

from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import frame_rnn, sample_mlp, samplernn
from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec
from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
from samplernn_pase_tpu_torch.ops.kernels import megagen
from samplernn_pase_tpu_torch.ops.kernels.noise import (
    as_lane_keys, gumbel_block, lane_gumbel_block)
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype
from samplernn_pase_tpu_torch.ops.mulaw import (
    levels_to_float, linear_dequantize, quantize_zero)
from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map
from samplernn_pase_tpu_torch.utils.profiling import note, spanned


def next_pow2(n: int) -> int:
    """Smallest power of two >= n: the one bucketing rule of the cond
    consumers (``set_cond`` stream buckets, ``StreamPool.extend_cond`` row
    buckets, ``StreamPool._ensure_cap`` growth)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def fit_cond_stream(cond, n_frames: int) -> np.ndarray:
    """Clamp-extend (repeat the last row) or trim a conditioning stream to
    exactly ``n_frames`` rows along axis -2.  Accepts [T, D] or [B, T, D]
    numpy-likes or tensors; returns float32 numpy."""
    if isinstance(cond, torch.Tensor):
        cond = cond.detach().cpu().numpy()
    cond = np.asarray(cond, np.float32)
    t = cond.shape[-2]
    if t == 0:
        raise ValueError(
            "empty conditioning stream: expected at least one "
            f"[{'...,' if cond.ndim > 2 else ''}frames, dim] row, got "
            f"shape {cond.shape}")
    if t < n_frames:
        pad = np.broadcast_to(
            cond[..., -1:, :],
            (*cond.shape[:-2], n_frames - t, cond.shape[-1]))
        cond = np.concatenate([cond, pad], axis=-2)
    return cond[..., :n_frames, :]


def kernel_scope_error(cfg: SampleRNNConfig) -> str | None:
    """Why the decode kernels cannot run ``cfg``, or None if they can: they
    take GRU and LSTM tiers of any n_rnn, tier count and f1."""
    if cfg.rnn_type not in ("gru", "lstm"):
        return f"the decode kernels take GRU or LSTM tiers, not " \
               f"{cfg.rnn_type}"
    return None


# ------------------------------------------------- argument helpers --

def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    """A tensor, numpy array or sequence as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def _is_lane_vec(x) -> bool:
    """True when a position argument is a per-lane [B] vector rather than
    a scalar."""
    return not isinstance(x, (int, np.integer)) and _ndim(x) == 1


def _position(x, n_seqs: int, device, name: str):
    """A position argument as an int, or an int64 [B] tensor on device."""
    if not _is_lane_vec(x):
        return int(x)
    t = _as_tensor(x, device, torch.int64)
    if t.shape != (n_seqs,):
        raise ValueError(f"{name} must be an int or [{n_seqs}], got "
                         f"{tuple(t.shape)}")
    return t


def _norm_lane_keys(lane_keys, n_seqs: int, temperature, device):
    """generate_levels' ``lane_keys`` as int64 [B, 2] words on device, or
    None (greedy decode ignores them)."""
    if lane_keys is None or temperature is None:
        return None
    if _ndim(lane_keys) == 1 and n_seqs == 1:
        lane_keys = lane_keys[None]
    keys = as_lane_keys(lane_keys, device)
    if keys.shape != (n_seqs, 2):
        raise ValueError(f"lane_keys must be [{n_seqs}, 2] 32-bit words "
                         f"(one key per lane), got {tuple(keys.shape)}")
    return keys


def _cond_tensor(cfg, cond, n_seqs: int, device):
    if cond is None:
        return None
    if not (cfg.cond_dim and cfg.cond_rate):
        raise ValueError("cond passed to a model without cond_dim/cond_rate")
    cond = _as_tensor(cond, device, torch.float32)
    if cond.dim() != 3 or cond.shape[0] != n_seqs \
            or cond.shape[2] != cfg.cond_dim or cond.shape[1] == 0:
        raise ValueError(f"cond must be [{n_seqs}, frames>0, "
                         f"{cfg.cond_dim}], got {tuple(cond.shape)}")
    return cond


# ------------------------------------------------------- plain route --

def _ext_cond_vec(cond, pos, cond_rate):
    """cond [B, F, D] -> the row active at sample ``pos`` (an int, or a [B]
    tensor of per-lane positions), clamped to the last row."""
    if cond is None:
        return None
    if isinstance(pos, torch.Tensor):
        idx = (pos // cond_rate).clamp(0, cond.shape[1] - 1)
        return cond[torch.arange(cond.shape[0], device=cond.device), idx]
    return cond[:, min(max(pos // cond_rate, 0), cond.shape[1] - 1)]


def _frame_noise(out, pos, b, f1, q_levels, device):
    """The [f1, B, q] Gumbel block of the bottom frame at in-call offset
    ``pos`` (None when greedy): per-lane keys or the shared seed, at noise
    positions ``noise_pos0 + pos``."""
    if not out["temperature"]:
        return None
    npos = out["noise_pos0"] + pos
    if out["lane_keys"] is not None:
        return lane_gumbel_block(out["lane_keys"], npos, f1, q_levels)
    return gumbel_block(out["seed"], b, npos, f1, q_levels, device)


def _decode_tier(params, cfg, k, hist, states, pos, upper_vec, out):
    """Decode one tier-k frame's worth of samples, recursively, on the
    plain model modules.

    hist [B, lookback] rolling history; states: per-tier states; pos:
    index of the frame's first sample within this call; upper_vec [B, dim]
    conditioning row from the parent tier (None at the top).  ``out``
    holds the conditioning and noise settings, the emitted blocks and, for
    rescoring, the forced samples.  Returns (hist, states)."""
    f1 = cfg.frame_sizes[0]
    span = cfg.tier_spans[k]
    temp = out["temperature"]
    ext = None
    if out["cond"] is not None:
        ext = _ext_cond_vec(out["cond"], out["cond_pos0"] + pos,
                            cfg.cond_rate)
    frame = levels_to_float(hist[:, -span:], cfg.q_levels)
    cond_rows, new_state = frame_rnn.tier_step(
        params["tiers"][k], frame, upper_vec, ext, states[k],
        frame_size=cfg.frame_sizes[k], rnn_type=cfg.rnn_type,
        compute_dtype=torch_dtype(cfg.compute_dtype))
    states = states[:k] + (new_state,) + states[k + 1:]
    if k == 0:
        g = _frame_noise(out, pos, hist.shape[0], f1, cfg.q_levels,
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
                    noise_pos0, forced=None, cond=None, cond_pos0=0,
                    lane_keys=None):
    out = {"temperature": temperature, "seed": seed,
           "noise_pos0": noise_pos0, "blocks": [], "forced": forced,
           "cond": cond, "cond_pos0": cond_pos0, "lane_keys": lane_keys}
    top = cfg.n_tiers - 1
    for step in range(n_steps):
        hist, states = _decode_tier(params, cfg, top, hist, states,
                                    step * cfg.lookback, None, out)
    levels = torch.cat(out["blocks"], dim=1)
    return levels, states, hist


# ------------------------------------------------------ kernel route --

@spanned("generate.prepare_weights")
def prepare_weights(params, cfg: SampleRNNConfig, device=None) -> dict:
    """The kernel route's form of ``params`` on ``device``: weight norm
    resolved, matrices cast to the compute dtype, the embedding folded
    into the MLP's first layer (f1 launches of K2).  Prepare once per
    model and pass the result to every request as ``kernel_weights``."""
    why = kernel_scope_error(cfg)
    if why:
        raise ValueError(why)
    params = tree_map(lambda t: t.to(resolve_device(device)), params)
    return megagen.prepare(params["tiers"], params["mlp"], cfg.compute_dtype)


@spanned("generate.project_cond")
def project_cond(weights, cfg, cond, cond_pos0, n_samples: int):
    """The megakernel's conditioning inputs for a call of ``n_samples``
    samples (``generate.py:_megagen_chunk`` :490-510 of the reference):
    each lane's rows from its origin ``cond_pos0_b // cond_rate``, ``need
    = (n_samples - 1) // cond_rate + 2`` of them clamped to the last row,
    projected through each tier's ``w_cond`` by K2 (one launch per tier)
    -> (per-tier [need, B, H] float32, cond_phase [B] int32, cond_rate)."""
    b, frames, d = cond.shape
    rate = cfg.cond_rate
    pos0 = (cond_pos0 if isinstance(cond_pos0, torch.Tensor)
            else torch.full((b,), int(cond_pos0), dtype=torch.int64,
                            device=cond.device))
    need = (n_samples - 1) // rate + 2
    idx = ((pos0 // rate)[:, None]
           + torch.arange(need, device=cond.device)).clamp(0, frames - 1)
    rows = cond.gather(1, idx[:, :, None].expand(b, need, d))
    flat = rows.reshape(b * need, d)
    ext = tuple(kdec.gemm_bias(flat, tw["w_cond"]).view(b, need, -1)
                .transpose(0, 1) for tw in weights["tiers"])
    return ext, (pos0 % rate).to(torch.int32), rate


def _generate_kernels(weights, cfg, length, temperature, seed, hist,
                      initial_states, noise_pos0, cond=None, cond_pos0=0,
                      lane_keys=None):
    """Whole generation through ``megagen.run``, in one call.

    Chunking rule on the H100: none.  The TPU chunks to bound the
    megakernel's VMEM output buffer (``_vmem_cap``); here the per-length
    allocations are the int32 level buffer (8 MB at B=128, 16,000
    samples) and, conditioned, the projected rows (101 x 128 x 1024 x 4 B,
    53 MB per tier at 16,000 samples); the noise is drawn in K1, so one
    call covers the whole length.  A caller that wants shorter calls
    splits the length itself and carries ``return_state``,
    ``cond_pos0`` and ``noise_pos0``."""
    n_top = -(-length // cfg.lookback)
    proj = None
    if cond is not None:
        proj = project_cond(weights, cfg, cond, cond_pos0,
                            n_top * cfg.lookback)
    levels, states = megagen.run(
        weights, hist, tuple(initial_states), temperature or 0.0, n_top,
        cfg.q_levels, seed=seed, pos0=noise_pos0, cond=proj,
        lane_keys=lane_keys)
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
        raise ValueError(why)
    return "kernels"


@spanned("generate.levels")
def generate_levels(params, cfg: SampleRNNConfig, n_seqs: int, length: int,
                    temperature: float | None = 1.0, seed: int = 0,
                    cond=None, initial_states=None, hist=None,
                    use_kernels: bool | str | None = None, speakers=None,
                    return_state: bool = False, cond_pos0=0, lane_keys=None,
                    noise_pos0=0, device=None, kernel_weights=None):
    """Generate quantized levels [n_seqs, length] int32.

    ``length`` is rounded up to a multiple of lookback and trimmed.
    ``temperature`` None or 0 = greedy.  ``seed``/``noise_pos0`` key the
    sampling noise, or ``lane_keys`` [B, 2] (uint32 words, one key per
    lane) with ``noise_pos0`` an int or a [B] tensor of per-lane
    positions (see the module docstring).  ``cond`` [B, F, cond_dim]
    conditioning rows read from ``cond_pos0`` (an int or a [B] tensor);
    ``speakers`` [B] ids fold the learned speaker embedding into it (over
    the whole stream, or over the frames this call generates when there is
    no stream).  ``initial_states`` (per tier [n_rnn, B, dim]; LSTM tiers
    [n_rnn, 2, B, dim]) and ``hist`` ([B, lookback] int32) continue a
    stream; ``return_state`` returns (levels, states, hist) to carry on.
    ``use_kernels``: None = kernels on CUDA, plain on CPU; True or
    "frame" = kernels; False = plain.  ``device``: where to run (default
    CUDA, which must be present); the parameters are moved there.
    ``kernel_weights``: ``prepare_weights(params, cfg, device)``, else the
    kernel route prepares them for this call."""
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
    cond = _cond_tensor(cfg, cond, n_seqs, dev)
    if speakers is not None:
        if not cfg.n_speakers:
            raise ValueError("speakers passed to a model without n_speakers")
        n_spk_frames = (cond.shape[1] if cond is not None
                        else max(-(-length // cfg.cond_rate), 1))
        cond = samplernn.speaker_cond(
            params, cfg, _as_tensor(speakers, dev), cond, n_spk_frames)
    cond_pos0 = _position(cond_pos0, n_seqs, dev, "cond_pos0")
    noise_pos0 = _position(noise_pos0, n_seqs, dev, "noise_pos0")
    lane_keys = _norm_lane_keys(lane_keys, n_seqs, temperature, dev)
    route = _route(use_kernels, dev, cfg)
    note(lanes=n_seqs, samples=length, route=route)
    if route == "kernels":
        if kernel_weights is None:
            kernel_weights = prepare_weights(params, cfg, dev)
        levels, states, hist = _generate_kernels(
            kernel_weights, cfg, length, temperature, seed, hist, states,
            noise_pos0, cond, cond_pos0, lane_keys)
    else:
        levels, states, hist = _generate_plain(
            params, cfg, hist, states, -(-length // lookback), temperature,
            seed, noise_pos0, cond=cond, cond_pos0=cond_pos0,
            lane_keys=lane_keys)
    # like the reference, a trimmed call's carried state and hist cover
    # its whole top frames
    levels = levels[:, :length]
    if return_state:
        return levels, states, hist
    return levels


def rescore(params, cfg: SampleRNNConfig, levels, temperature=None,
            seed: int = 0, noise_pos0=0, initial_states=None, hist=None,
            cond=None, cond_pos0=0, lane_keys=None) -> float:
    """Share of ``levels`` [B, T] (T a multiple of lookback) that the plain
    per-step modules pick again when fed the emitted history: at every
    position, ``argmax(logits + temperature * g)`` with the same Philox
    noise (shared seed or ``lane_keys``) and the same conditioning (``cond``
    read from ``cond_pos0``; speakers already folded in).  The bf16 check
    of a kernel route, which cannot be bitwise."""
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
    temperature = temperature or None
    with torch.no_grad():
        picked, _, _ = _generate_plain(
            params, cfg, hist, tuple(initial_states), t // cfg.lookback,
            temperature, seed, _position(noise_pos0, b, dev, "noise_pos0"),
            forced=levels.to(torch.int32),
            cond=_cond_tensor(cfg, cond, b, dev),
            cond_pos0=_position(cond_pos0, b, dev, "cond_pos0"),
            lane_keys=_norm_lane_keys(lane_keys, b, temperature, dev))
    return float((picked == levels).to(torch.float32).mean())


def prime(params, cfg: SampleRNNConfig, levels, cond=None, speakers=None,
          max_context: int | None = 32_768, device=None):
    """Warm the decoder state from a seed waveform (audio continuation).

    Runs the teacher-forced ``samplernn.forward`` over the tail of
    ``levels`` [B, L] int (L >= 2*lookback for any state warm-up; shorter
    seeds only fill the sample window) and returns ``(states, hist)`` for
    ``generate_levels``' ``initial_states=``/``hist=``.  ``cond`` rows, if
    given, follow the corpus convention (row r covers seed samples
    [r*cond_rate, (r+1)*cond_rate)): forward's row 0 is the row of the
    first target sample of the primed window.  ``max_context`` bounds the
    teacher-forced span (None: the whole seed)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    levels = _as_tensor(levels, dev, torch.int32)
    b, total = levels.shape
    lookback = cfg.lookback
    states = samplernn.initial_state(params, cfg, b)
    if total < lookback:
        hist = torch.cat([
            torch.full((b, lookback - total), quantize_zero(cfg.q_levels),
                       dtype=torch.int32, device=dev), levels], dim=1)
        return states, hist
    # the largest tail usable as [lookback context + T], T % lookback == 0
    t = (total - lookback) // lookback * lookback
    if max_context is not None:
        t = min(t, max(max_context // lookback, 1) * lookback)
    hist = levels[:, total - lookback:]
    if t <= 0:
        return states, hist
    inputs = levels[:, total - lookback - t:]
    if cond is not None:
        cond = _as_tensor(cond, dev, torch.float32)
        # row 0 of forward covers the first target sample
        # (levels[total - t]); a stream that stops short keeps its last row
        row0 = min((total - t) // cfg.cond_rate, cond.shape[1] - 1)
        cond = cond[:, row0:]
    if speakers is not None:
        speakers = _as_tensor(speakers, dev)
    with torch.no_grad():
        _, states = samplernn.forward(params, cfg, inputs, states, cond=cond,
                                      speakers=speakers)
    return states, hist


def decode_waveform(levels, cfg: SampleRNNConfig) -> torch.Tensor:
    """Quantized levels [..., T] -> float waveform in [-1, 1] with the
    model's codec: mu-law through K7 (``ops/kernels/codec.py``; its plain
    version on CPU tensors), linear in plain PyTorch (the reference has no
    kernel for it)."""
    if cfg.codec == "linear":
        return linear_dequantize(levels, cfg.q_levels)
    levels = torch.as_tensor(levels)
    flat = levels.to(torch.int32).reshape(-1, levels.shape[-1])
    return kcodec.mu_law_decode(flat, cfg.q_levels).reshape(levels.shape)


def generate(params, cfg: SampleRNNConfig, n_seqs: int, length: int,
             temperature: float | None = 1.0, seed: int = 0, cond=None,
             use_kernels: bool | str | None = None, speakers=None,
             device=None) -> torch.Tensor:
    """Generate float waveforms [n_seqs, length] in [-1, 1]."""
    levels = generate_levels(params, cfg, n_seqs, length, temperature, seed,
                             cond, use_kernels=use_kernels,
                             speakers=speakers, device=device)
    return decode_waveform(levels, cfg)


class KernelWeights:
    """Kernel weights prepared once and kept while the same parameter
    tensors, unmodified, come back; new or modified parameters are
    prepared again.  None on the plain route."""

    def __init__(self, cfg, device, use_kernels):
        self.cfg, self.device = cfg, device
        self.kernels = _route(use_kernels, device, cfg) == "kernels"
        self.key, self.weights = None, None

    def __call__(self, params):
        if not self.kernels:
            return None
        key = tuple((id(t), t._version) for t in tree_leaves(params))
        if key != self.key:
            self.weights = prepare_weights(params, self.cfg, self.device)
            # holding the tensors keeps the ids in the key from reuse
            self.key, self.params = key, params
        return self.weights


def make_generator(cfg: SampleRNNConfig, n_seqs: int, length: int,
                   temperature: float | None = 1.0,
                   conditioned: bool = False,
                   use_kernels: bool | str | None = None, device=None):
    """A generator fn (params, seed) -> levels [n_seqs, length], or with
    ``conditioned`` (params, seed, cond).

    On the kernel route it prepares ``params``' kernel weights once and
    keeps them while the same tensors, unmodified, come back; new or
    modified parameters are prepared again."""
    dev = resolve_device(device)
    weights = KernelWeights(cfg, dev, use_kernels)

    def run(params, seed, cond):
        return generate_levels(params, cfg, n_seqs, length, temperature,
                               seed, cond, use_kernels=use_kernels,
                               device=dev, kernel_weights=weights(params))

    if conditioned:
        def fn(params, seed, cond):
            return run(params, seed, cond)
    else:
        def fn(params, seed=0):
            return run(params, seed, None)
    return fn


class StreamingGenerator:
    """Stateful serving-style decoder: emit audio in chunks, carrying
    per-tier state and the sample window across calls.

    Chunk lengths are multiples of ``cfg.lookback``.  Conditioned models
    take their conditioning per chunk (``emit(cond=...)``,
    ``chunks_per_call=1`` only) or, the TTS serving path, as a whole
    stream through ``set_cond``: the generator advances through it with
    its sample cursor ``pos``, so buffered lookahead (``chunks_per_call >
    1``) works conditioned too.

    ``chunks_per_call=K``: ``emit(n)`` generates K*n samples in one call
    and serves them from a buffer one chunk per call.  Noise is a pure
    function of (key, lane, position): the shared ``seed``, counted from
    ``pos``, or the per-lane ``stream_keys`` [n, 2] uint32 words (the pool
    lanes' form), so greedy and sampled streams alike do not depend on K
    or on the chunking.  Every K'th call bears the generation cost.

    Runs on ``device`` (default CUDA) through ``use_kernels``' route; the
    kernel route prepares its weights once.
    """

    def __init__(self, params, cfg: SampleRNNConfig, n_seqs: int,
                 temperature: float | None = 1.0, seed: int = 0,
                 use_kernels: bool | str | None = None,
                 chunks_per_call: int = 1, stream_keys=None, device=None):
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg, self.n = cfg, n_seqs
        self.temperature = temperature
        self.seed = int(seed)
        self._stream_keys = _norm_lane_keys(stream_keys, n_seqs,
                                            temperature or None, self.device)
        self.use_kernels = use_kernels
        self._weights = KernelWeights(cfg, self.device, use_kernels)
        self.chunks_per_call = max(1, int(chunks_per_call))
        self._buffer = None            # pending levels [n, m]
        self._buffer_speakers = None   # speakers the buffer was made for
        self._cond_stream = None       # the whole [n, F, D] stream
        self._cond_frames = 0          # its unpadded row count
        self.reset()

    def set_cond(self, cond):
        """Attach the whole conditioning stream of this utterance: [frames,
        D] (broadcast over lanes) or [n_seqs, frames, D].  Row r
        conditions samples [r*cond_rate, (r+1)*cond_rate); decode past the
        last row clamps to it.  The stream is padded to a power-of-two row
        count by repeating its last row (the same clamp), kept on the
        device, and read from the sample cursor at every emit.

        Attaching mid-stream (pos > 0) reads the new stream from the
        cursor: the progressive-extension pattern (more rows of the same
        utterance).  For a new utterance call ``reset()`` first; with
        pending buffered lookahead a stream that does not extend the
        current one raises."""
        if not (self.cfg.cond_dim and self.cfg.cond_rate):
            raise ValueError(
                "set_cond on a model without cond_dim/cond_rate")
        if isinstance(cond, torch.Tensor):
            cond = cond.detach().cpu().numpy()
        cond = np.asarray(cond, np.float32)
        if cond.ndim == 2:
            cond = np.broadcast_to(cond[None], (self.n, *cond.shape))
        if cond.ndim != 3 or cond.shape[0] != self.n \
                or cond.shape[2] != self.cfg.cond_dim:
            raise ValueError(
                f"set_cond expects [frames, {self.cfg.cond_dim}] or "
                f"[{self.n}, frames, {self.cfg.cond_dim}], got "
                f"{cond.shape}")
        if cond.shape[1] == 0:
            raise ValueError("empty conditioning stream")
        if self.pending:
            # the buffered lookahead was generated under the previous
            # stream: fine when the new one extends it (same prefix, more
            # rows), silent corruption otherwise
            prev = self._cond_stream
            pf = min(self._cond_frames, cond.shape[1])
            is_ext = (prev is not None
                      and cond.shape[1] >= self._cond_frames
                      and np.array_equal(prev[:, :pf].cpu().numpy(),
                                         cond[:, :pf]))
            if not is_ext:
                raise ValueError(
                    f"set_cond with {self.pending} samples of pending "
                    "lookahead audio generated under a DIFFERENT cond "
                    "stream; reset() for a new utterance (extending "
                    "the current stream -- same prefix, more rows -- is "
                    "allowed)")
        self._cond_frames = cond.shape[1]
        bucket = next_pow2(cond.shape[1])
        if bucket != cond.shape[1]:
            cond = fit_cond_stream(cond, bucket)
        self._cond_stream = torch.tensor(cond, device=self.device)
        return self

    @property
    def pending(self) -> int:
        """Samples of buffered lookahead audio not yet served."""
        return 0 if self._buffer is None else int(self._buffer.shape[1])

    def prime(self, levels, cond=None, speakers=None,
              max_context: int | None = 32_768):
        """Warm this stream's state on a seed waveform (levels [n_seqs, L]
        int) so later emits continue it: the serving-side ``prime``."""
        self.states, self.hist = prime(
            self.params, self.cfg, levels, cond=cond, speakers=speakers,
            max_context=max_context, device=self.device)
        self._buffer = None   # buffered lookahead predates the seed
        self.pos = 0          # the cond stream covers generated samples
        return self

    def _generate(self, n_samples: int, cond, speakers):
        pos0 = 0
        if cond is None and self._cond_stream is not None:
            cond, pos0 = self._cond_stream, self.pos
        levels, self.states, self.hist = generate_levels(
            self.params, self.cfg, self.n, n_samples, self.temperature,
            self.seed, cond=cond, initial_states=self.states, hist=self.hist,
            use_kernels=self.use_kernels, speakers=speakers,
            return_state=True, cond_pos0=pos0, lane_keys=self._stream_keys,
            noise_pos0=self.pos, device=self.device,
            kernel_weights=self._weights(self.params))
        self.pos += n_samples
        return levels

    def emit(self, n_samples: int, cond=None, speakers=None):
        """The next ``n_samples`` levels [n_seqs, n_samples] int32 (a device
        tensor; the work is queued on the current stream)."""
        if n_samples % self.cfg.lookback:
            raise ValueError(
                f"n_samples must be a multiple of lookback "
                f"({self.cfg.lookback})")
        if self.chunks_per_call == 1:
            return self._generate(n_samples, cond, speakers)
        # buffered: the decode state is ahead of the served samples, so a
        # conditioning or speaker change while lookahead is pending cannot
        # be honoured
        pending = self.pending
        if cond is not None:
            if pending:
                raise ValueError(
                    "emit(cond=...) with pending lookahead audio: the "
                    f"buffer holds {pending} samples generated without "
                    "this conditioning. Use chunks_per_call=1 for "
                    "conditioned streams.")
            return self._generate(n_samples, cond, speakers)
        spk = None if speakers is None else np.asarray(speakers)
        same = ((spk is None and self._buffer_speakers is None)
                or (spk is not None and self._buffer_speakers is not None
                    and np.array_equal(spk, self._buffer_speakers)))
        if pending and not same:
            raise ValueError(
                "emit(speakers=...) changed while lookahead audio is "
                "pending; the buffered samples were generated for "
                f"speakers={self._buffer_speakers}. Use "
                "chunks_per_call=1 for per-chunk speaker switching.")
        # one call per K chunks, topped up only to K * n_samples in all
        if pending < n_samples:
            fresh = self._generate(
                self.chunks_per_call * n_samples - pending, None, speakers)
            self._buffer_speakers = spk
            self._buffer = (fresh if not pending
                            else torch.cat([self._buffer, fresh], dim=1))
        out = self._buffer[:, :n_samples]
        self._buffer = self._buffer[:, n_samples:]
        return out

    def reset(self):
        """Back to a fresh stream: initial state, the q_zero window, no
        lookahead, the cursor (and with it the noise position) at 0.  An
        attached stream (``set_cond``) is kept."""
        self.states = samplernn.initial_state(self.params, self.cfg, self.n)
        self.hist = torch.full((self.n, self.cfg.lookback),
                               quantize_zero(self.cfg.q_levels),
                               dtype=torch.int32, device=self.device)
        self._buffer = None
        self._buffer_speakers = None
        self.pos = 0
        return self

    def emit_waveform(self, n_samples: int, cond=None, speakers=None):
        return decode_waveform(self.emit(n_samples, cond, speakers),
                               self.cfg)

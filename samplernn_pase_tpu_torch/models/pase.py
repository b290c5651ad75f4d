"""PASE waveform encoder, as ``samplernn_pase_tpu.models.pase``: the
SincNet front-end (a band-pass filter bank built from learnable cutoffs
on every call), a trunk of strided convolution blocks with BatchNorm and
PReLU, and a 1x1 projection to ``emb_dim``.  Total decimation is
``prod(strides)`` (160 by default: 16 kHz audio -> 100 Hz embeddings).

The convolutions are ``F.conv1d`` (cuDNN on the card), as the reference's
are ``lax.conv_general_dilated`` outside any Pallas kernel.  Three points
keep the port on the reference's numbers:

* XLA's SAME padding, ``out = ceil(T / stride)`` with the odd pad on the
  right, applied with ``F.pad`` (torch's ``padding='same'`` takes no
  stride > 1, and an even kernel pads asymmetrically);
* BatchNorm as written: the batch statistics use the biased variance,
  the running update is ``(1 - m) * old + m * batch`` of that variance,
  and ``count`` counts the updates (``F.batch_norm`` tracks the unbiased
  variance);
* rounding points: input and filters cast to ``compute_dtype``, the conv
  output in that dtype, then float32 for BN, PReLU and ``abs``.

On the card the convolutions run under ``conv_numerics``: cuDNN's
deterministic algorithms (no atomics in the weight gradient, so a resumed
joint run repeats the uninterrupted one bit for bit), no autotuning, and
no TF32 in float32 convolutions.

Layout: waveforms [B, T]; activations [B, C, T]; conv weights
``[out, in, k]`` in both frameworks.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from samplernn_pase_tpu_torch.config import PASEConfig
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.ops import init as winit
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype
from samplernn_pase_tpu_torch.parallel.mesh import sum_differentiable
from samplernn_pase_tpu_torch.tree import tree_map

F32 = torch.float32


@contextlib.contextmanager
def conv_numerics():
    """cuDNN settings for the encoder's convolutions and their gradients:
    deterministic algorithms, no benchmark autotuning, full float32
    products.  The previous settings come back on exit."""
    c = torch.backends.cudnn
    saved = (c.deterministic, c.benchmark, c.allow_tf32)
    c.deterministic, c.benchmark, c.allow_tf32 = True, False, False
    try:
        yield
    finally:
        c.deterministic, c.benchmark, c.allow_tf32 = saved


# ---------------------------------------------------------------- SincConv

def _mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _inv_mel(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def init_sinc(cfg: PASEConfig) -> dict:
    """Mel-spaced initial cutoffs (SincNet init); draws nothing."""
    n = cfg.sinc_filters
    low_hz = cfg.min_low_hz
    high_hz = cfg.sample_rate / 2.0 - (cfg.min_low_hz + cfg.min_band_hz)
    hz = _inv_mel(np.linspace(_mel(low_hz), _mel(high_hz), n + 1))
    return {"low_hz": torch.tensor(hz[:-1], dtype=F32),
            "band_hz": torch.tensor(np.diff(hz), dtype=F32)}


def sinc_filters(params, cfg: PASEConfig) -> torch.Tensor:
    """The [filters, kernel] band-pass bank from the cutoff params, in
    float32 with the reference's operations in its order: a Hamming window
    over ``arange(k) / (k - 1)`` and each filter divided by
    ``2 (high - low)``."""
    k = cfg.sinc_kernel
    half = (k - 1) // 2
    sr = cfg.sample_rate
    dev = params["low_hz"].device
    low = cfg.min_low_hz + torch.abs(params["low_hz"])
    # jnp.clip's maximum-then-minimum: a tie passes half the gradient.
    # The bounds are filled on the device: torch.tensor(x, device=cuda)
    # copies from pageable memory and waits for the card.
    high = torch.minimum(
        torch.full((), sr / 2.0, dtype=F32, device=dev),
        torch.maximum(torch.full((), cfg.min_low_hz, dtype=F32, device=dev),
                      low + cfg.min_band_hz + torch.abs(params["band_hz"])))
    n = torch.arange(1, half + 1, dtype=F32, device=dev) / sr      # [half]
    window = 0.54 - 0.46 * torch.cos(
        2.0 * math.pi * torch.arange(k, dtype=F32, device=dev) / (k - 1))
    f_times_t = 2.0 * math.pi * n[None, :]
    right = ((torch.sin(high[:, None] * f_times_t)
              - torch.sin(low[:, None] * f_times_t))
             / (math.pi * n[None, :]))                              # [F, half]
    center = 2.0 * (high - low)[:, None]
    filt = torch.cat([torch.flip(right, (1,)), center, right], dim=1)
    filt = filt * window[None, :]
    return filt / (2.0 * (high - low))[:, None]


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(..., padding="SAME")`` on [B, C, T]:
    ceil(T / stride) outputs, the odd pad on the right."""
    t, k = x.shape[-1], w.shape[-1]
    out = -(-t // stride)
    total = max((out - 1) * stride + k - t, 0)
    lo = total // 2
    return F.conv1d(F.pad(x, (lo, total - lo)), w, stride=stride)


def sinc_conv(params, x, cfg: PASEConfig) -> torch.Tensor:
    """x [B, T] -> [B, filters, T] float32 (stride 1, SAME)."""
    dt = torch_dtype(cfg.compute_dtype)
    filt = sinc_filters(params, cfg).to(dt)
    return _conv_same(x[:, None, :].to(dt), filt[:, None, :], 1).to(F32)


# ------------------------------------------------------------- conv trunk

def init_conv_block(gen: torch.Generator, c_in: int, c_out: int,
                    kernel: int) -> dict:
    """No conv bias: the block's BatchNorm re-centres the conv output, so
    a bias is degenerate (imported torch checkpoints fold theirs into the
    running mean, ``load_torch_pase``)."""
    return {
        "w": winit.lecun_uniform(gen, (c_out, c_in, kernel),
                                 fan_in=c_in * kernel),
        "alpha": torch.full((c_out,), 0.25),   # PReLU slope
        "bn_scale": torch.ones((c_out,)),
        "bn_bias": torch.zeros((c_out,)),
    }


def init_bn_state(c_out: int) -> dict:
    return {"mean": torch.zeros((c_out,)), "var": torch.ones((c_out,)),
            "count": torch.zeros(())}


def _bn_prelu(params, bn_state, x, *, train: bool, momentum: float = 0.1,
              eps: float = 1e-5, group=None):
    """BatchNorm over (batch, time) and PReLU on float32 [B, C, T].  In
    train mode the batch's mean and biased variance normalise (with their
    gradients) and update the running state, which carries no autograd
    history; in eval mode the running state normalises and is returned
    as it is.

    ``group``: the mesh's ``data`` group when ``x`` is this rank's block
    of the batch.  The statistics are then the whole batch's, in the same
    two passes: the sum, then the centred sum of squares, each summed over
    the group with the count (gradients flow back through both sums), so
    the running state stays equal on every rank."""
    if train and group is not None:
        n = x.shape[0] * x.shape[2] * dist.get_world_size(group)
        mean = sum_differentiable(torch.sum(x, dim=(0, 2)), group) / n
        xc = x - mean[None, :, None]
        var = sum_differentiable(torch.sum(xc * xc, dim=(0, 2)), group) / n
    elif train:
        mean = torch.mean(x, dim=(0, 2))
        xc = x - mean[None, :, None]
        var = torch.mean(xc * xc, dim=(0, 2))
    if train:
        new_state = {
            "mean": ((1 - momentum) * bn_state["mean"]
                     + momentum * mean.detach()),
            "var": (1 - momentum) * bn_state["var"] + momentum * var.detach(),
            "count": bn_state["count"] + 1,
        }
    else:
        mean, var = bn_state["mean"], bn_state["var"]
        new_state = bn_state
    x = (x - mean[None, :, None]) * torch.rsqrt(var[None, :, None] + eps)
    x = x * params["bn_scale"][None, :, None] \
        + params["bn_bias"][None, :, None]
    alpha = params["alpha"][None, :, None]
    return torch.where(x >= 0, x, alpha * x), new_state


def conv_block_apply(params, bn_state, x, stride: int, *, train: bool,
                     compute_dtype, momentum: float = 0.1,
                     eps: float = 1e-5, group=None):
    """x [B, C_in, T] -> ([B, C_out, ceil(T / stride)], new_bn_state);
    ``group`` as in ``_bn_prelu``."""
    dt = torch_dtype(compute_dtype)
    out = _conv_same(x.to(dt), params["w"].to(dt), stride).to(F32)
    return _bn_prelu(params, bn_state, out, train=train, momentum=momentum,
                     eps=eps, group=group)


# ------------------------------------------------------------------ WaveFe

def init_pase(gen: torch.Generator, cfg: PASEConfig, device=None):
    """(params, bn_state) for the whole encoder, drawn from ``gen`` (a CPU
    generator, so a seed gives the same weights on every device) and
    moved to ``device``: the card unless the caller asks for the CPU."""
    params = {"sinc": init_sinc(cfg), "blocks": [], "bn_sinc": {
        "alpha": torch.full((cfg.sinc_filters,), 0.25),
        "bn_scale": torch.ones((cfg.sinc_filters,)),
        "bn_bias": torch.zeros((cfg.sinc_filters,)),
    }}
    bn_state = {"sinc": init_bn_state(cfg.sinc_filters), "blocks": []}
    c_in = cfg.sinc_filters
    for c_out, kernel, _stride in cfg.blocks:
        params["blocks"].append(init_conv_block(gen, c_in, c_out, kernel))
        bn_state["blocks"].append(init_bn_state(c_out))
        c_in = c_out
    params["proj"] = init_conv_block(gen, c_in, cfg.emb_dim, 1)
    bn_state["proj"] = init_bn_state(cfg.emb_dim)
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device), (params, bn_state))


def pase_apply(params, bn_state, wav, cfg: PASEConfig, *,
               train: bool = False, group=None):
    """wav [B, T] float in [-1, 1] -> (emb [B, T // decimation, emb_dim]
    float32, new_bn_state).  ``group``: the mesh's ``data`` group when
    ``wav`` is this rank's block of the batch (train-mode BatchNorm then
    takes the whole batch's statistics)."""
    dt = torch_dtype(cfg.compute_dtype)
    with conv_numerics():
        # rectified band energies (SincNet front-end practice)
        x = torch.abs(sinc_conv(params["sinc"], wav, cfg))
        x, bn_sinc = _bn_prelu(params["bn_sinc"], bn_state["sinc"], x,
                               train=train, group=group)
        new_blocks = []
        for blk, st, (_, _, stride) in zip(params["blocks"],
                                           bn_state["blocks"], cfg.blocks):
            x, st2 = conv_block_apply(blk, st, x, stride, train=train,
                                      compute_dtype=dt, group=group)
            new_blocks.append(st2)
        x, bn_proj = conv_block_apply(params["proj"], bn_state["proj"], x,
                                      1, train=train, compute_dtype=dt,
                                      group=group)
    new_state = {"sinc": bn_sinc, "blocks": new_blocks, "proj": bn_proj}
    return x.transpose(1, 2), new_state


# ------------------------------------------------------- torch ckpt import

def load_torch_pase(path, cfg: PASEConfig, strict: bool = True):
    """Import upstream PASE encoder weights from a torch state_dict file
    (SincNet-style ``low_hz_``/``band_hz_`` and per-block conv, norm and
    act keys) onto the port's tree, on the CPU.  Keys absent from the file
    keep ``init_pase``'s values for seed 0.  Upstream conv biases fold
    into the running mean (the blocks carry none).  Returns (params,
    bn_state, report): ``report`` lists the loaded and skipped keys and
    the blocks without a weight.

    ``strict`` (default): raise if the file yields no tensor or misses a
    conv block's weight, with the report in the message: a key-layout
    mismatch must not pass as a random-init encoder.  The file is read
    with ``weights_only=True`` (tensors and containers only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    params, bn_state = init_pase(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
    used = set()

    def grab(*names):
        for n in names:
            if n in sd:
                used.add(n)
                return sd[n].detach().clone()
        return None

    def check_shape(name, v, want):
        if v is not None and tuple(v.shape) != tuple(want):
            raise ValueError(
                f"PASE import: {name} has shape {tuple(v.shape)}, "
                f"config expects {tuple(want)} — checkpoint does not "
                f"match PASEConfig (cfg.blocks={cfg.blocks})")

    for ours, names in (("low_hz", ("sinc.low_hz_", "blocks.0.conv.low_hz_")),
                        ("band_hz", ("sinc.band_hz_",
                                     "blocks.0.conv.band_hz_"))):
        v = grab(*names)
        if v is not None:
            v = v.reshape(-1)
            check_shape(f"sinc {ours}", v, (cfg.sinc_filters,))
            params["sinc"][ours] = v
    # the sinc block's own norm/act (upstream blocks.0.norm / blocks.0.act)
    for ours, theirs in (("bn_scale", "norm.weight"), ("bn_bias", "norm.bias"),
                         ("alpha", "act.weight")):
        v = grab(f"blocks.0.{theirs}")
        if v is not None:
            params["bn_sinc"][ours] = v
    for ours, theirs in (("mean", "norm.running_mean"),
                         ("var", "norm.running_var")):
        v = grab(f"blocks.0.{theirs}")
        if v is not None:
            bn_state["sinc"][ours] = v
    missing_blocks = []
    for i in range(len(cfg.blocks)):
        p = f"blocks.{i + 1}"
        w = grab(f"{p}.conv.weight")
        if w is None:
            missing_blocks.append(i)
            continue
        blk, st = params["blocks"][i], bn_state["blocks"][i]
        check_shape(f"{p}.conv.weight", w, blk["w"].shape)
        blk["w"] = w
        for ours, theirs in (("bn_scale", "norm.weight"),
                             ("bn_bias", "norm.bias")):
            v = grab(f"{p}.{theirs}")
            if v is not None:
                blk[ours] = v
        for ours, theirs in (("mean", "norm.running_mean"),
                             ("var", "norm.running_var")):
            v = grab(f"{p}.{theirs}")
            if v is not None:
                st[ours] = v
        b = grab(f"{p}.conv.bias")
        if b is not None:
            # eval output (conv + b - mean) == (conv - (mean - b)) exactly;
            # in train mode the batch statistics cancel a bias anyway
            st["mean"] = st["mean"] - b
        a = grab(f"{p}.act.weight")
        if a is not None:
            blk["alpha"] = a
    # the final projection (upstream WaveFe's output conv ``W``; the
    # exporter writes the namespaced form)
    w = grab("W.weight", "proj.conv.weight")
    if w is not None:
        check_shape("proj.conv.weight", w, params["proj"]["w"].shape)
        params["proj"]["w"] = w
        for ours, theirs in (("bn_scale", "proj.norm.weight"),
                             ("bn_bias", "proj.norm.bias"),
                             ("alpha", "proj.act.weight")):
            v = grab(theirs)
            if v is not None:
                params["proj"][ours] = v
        for ours, theirs in (("mean", "proj.norm.running_mean"),
                             ("var", "proj.norm.running_var")):
            v = grab(theirs)
            if v is not None:
                bn_state["proj"][ours] = v
        b = grab("W.bias", "proj.conv.bias")
        if b is not None:   # folded into the running mean, as the blocks'
            bn_state["proj"]["mean"] = bn_state["proj"]["mean"] - b
    report = {"loaded": sorted(used), "skipped": sorted(set(sd) - used),
              "missing_blocks": missing_blocks}
    if strict and (not used or missing_blocks):
        what = ("loaded ZERO tensors" if not used else
                f"conv blocks {missing_blocks} have no "
                f"blocks.{{i+1}}.conv.weight key")
        raise ValueError(
            f"PASE import from {path}: {what} — the checkpoint's key "
            f"layout does not match the expected SincNet/WaveFe scheme. "
            f"Loaded {len(report['loaded'])} keys; skipped keys present "
            f"in the file: {report['skipped'][:20]}"
            f"{'...' if len(report['skipped']) > 20 else ''}. "
            "Pass strict=False to proceed with a partially (or fully) "
            "random-init encoder.")
    return params, bn_state, report


def absorb_legacy_bias(params, bn_state):
    """Migrate a tree whose conv blocks still carry a bias ``b`` (written
    before the blocks dropped it): fold it into the BN running mean (eval
    output ``conv + b`` normalised by ``mean`` equals ``conv`` normalised
    by ``mean - b``) and zero the leaf rather than delete it, so that a
    restored optimizer state keeps a matching tree while the forward never
    reads it.  Returns (params, bn_state, changed); no-op on current
    trees."""
    if not (any("b" in blk for blk in params.get("blocks", []))
            or "b" in params.get("proj", {})):
        return params, bn_state, False
    params, bn_state = dict(params), dict(bn_state)
    blocks, bstates = [], []
    for blk, st in zip(params["blocks"], bn_state["blocks"]):
        if "b" in blk:
            st = dict(st, mean=st["mean"] - blk["b"])
            blk = dict(blk, b=torch.zeros_like(blk["b"]))
        blocks.append(blk)
        bstates.append(st)
    params["blocks"], bn_state["blocks"] = blocks, bstates
    if "b" in params["proj"]:
        bn_state["proj"] = dict(bn_state["proj"], mean=bn_state["proj"]["mean"]
                                - params["proj"]["b"])
        params["proj"] = dict(params["proj"],
                              b=torch.zeros_like(params["proj"]["b"]))
    return params, bn_state, True


def export_torch_pase(params, bn_state, path=None) -> dict:
    """The encoder as an upstream-style torch state_dict (the inverse key
    mapping of :func:`load_torch_pase`), float32 CPU tensors; written with
    ``torch.save`` when ``path`` is given.  A legacy tree's conv bias is
    folded first, so the exported (zero bias, mean) pair is the function
    the tree computes; each conv gets an explicit zero bias so a strict
    ``load_state_dict`` upstream finds every key."""
    params, bn_state, _ = absorb_legacy_bias(params, bn_state)

    def t(x):
        return x.detach().to("cpu", F32).clone()

    sd = {
        # upstream SincConv_fast stores cutoffs as [F, 1]
        "blocks.0.conv.low_hz_": t(params["sinc"]["low_hz"]).reshape(-1, 1),
        "blocks.0.conv.band_hz_": t(params["sinc"]["band_hz"]).reshape(-1, 1),
        "blocks.0.norm.weight": t(params["bn_sinc"]["bn_scale"]),
        "blocks.0.norm.bias": t(params["bn_sinc"]["bn_bias"]),
        "blocks.0.norm.running_mean": t(bn_state["sinc"]["mean"]),
        "blocks.0.norm.running_var": t(bn_state["sinc"]["var"]),
        "blocks.0.act.weight": t(params["bn_sinc"]["alpha"]),
    }
    named = [(f"blocks.{i + 1}", blk, st) for i, (blk, st) in enumerate(
        zip(params["blocks"], bn_state["blocks"]))]
    named.append(("proj", params["proj"], bn_state["proj"]))
    for p, blk, st in named:
        sd[f"{p}.conv.weight"] = t(blk["w"])
        sd[f"{p}.conv.bias"] = torch.zeros(blk["w"].shape[0])
        sd[f"{p}.norm.weight"] = t(blk["bn_scale"])
        sd[f"{p}.norm.bias"] = t(blk["bn_bias"])
        sd[f"{p}.norm.running_mean"] = t(st["mean"])
        sd[f"{p}.norm.running_var"] = t(st["var"])
        sd[f"{p}.act.weight"] = t(blk["alpha"])
    if path is not None:
        torch.save(sd, path)
    return sd

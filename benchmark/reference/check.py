"""Comparisons that decide ``correct``: what the reference computes from the
program's outputs, and the readings of the control beside them.

A served token is judged by the gap by which its score (logit plus the
temperature times its Gumbel noise, which the reference replays) lies
below the reference's best score at that position; the number compared
is the widest gap over every checked position.  The control, the
reference in float8 put in the program's place, is read at the same
positions: the gap of the token that it puts first.
"""

from __future__ import annotations

import torch

from benchmark.reference import mulaw, philox
from benchmark.reference import samplernn as ref


def noise(spec, pos: torch.Tensor, q_levels: int) -> torch.Tensor:
    """Gumbel noise [B, T, Q] at positions pos [B, T] for lanes described
    by ``spec``: ("seed", seeds [B], lanes [B]) for the shared-seed mode
    (each lane's request seed and its index in the request) or ("keys",
    keys [B, 2]) for per-lane keys."""
    dev = pos.device
    if spec[0] == "seed":
        seeds = torch.as_tensor(spec[1], dtype=torch.int64, device=dev)
        key = (seeds & 0xFFFFFFFF, (seeds >> 32) & 0xFFFFFFFF)
        lane = torch.as_tensor(spec[2], dtype=torch.int64, device=dev)
    else:
        keys = torch.as_tensor(spec[1], dtype=torch.int64, device=dev)
        key = (keys[:, 0], keys[:, 1])
        lane = torch.zeros(keys.shape[0], dtype=torch.int64, device=dev)
    b = pos.shape[0]
    return philox.gumbel((key[0].view(b, 1), key[1].view(b, 1)),
                         lane.view(b, 1), pos, q_levels)


@torch.no_grad()
def token_gaps(params, cfg, served, lengths, noise_spec, temperature: float,
               cond=None, control: bool = False, block: int = 4096) -> dict:
    """Replay served lanes through the reference.

    served [B, L] int levels (each lane from stream position 0; padding
    past ``lengths`` [B] is ignored), ``noise_spec`` as ``noise``, cond
    [B, R, D] rows or None.  Returns ``{"gap": widest gap of a served
    token, "tokens": positions checked}`` and, with ``control``,
    ``"control_gap"``: the widest gap of the float8 reference's own first
    choice at the same positions."""
    ref.full_float32()
    lb = ref.lookback(cfg)
    q = cfg["q_levels"]
    dev = served.device
    b, total = served.shape
    block = max(lb, block // lb * lb)
    n = -(-total // lb) * lb
    levels = torch.full((b, lb + n), q // 2, dtype=torch.int64, device=dev)
    levels[:, lb:lb + total] = served.long()
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    runs = [("float32", ref.initial_state(params, cfg, b),
             ref.mlp_table(params, cfg, "float32"))]
    if control:
        runs.append(("fp8", ref.initial_state(params, cfg, b),
                     ref.mlp_table(params, cfg, "fp8")))
    gap = torch.zeros((), device=dev)
    cgap = torch.zeros((), device=dev)
    for s in range(0, n, block):
        t = min(block, n - s)
        inputs = levels[:, s:s + lb + t]
        pos = (s + torch.arange(t, device=dev)).view(1, t).expand(b, t)
        g = noise(noise_spec, pos, q) if temperature else None
        valid = pos < lengths.view(b, 1)
        target = levels[:, lb + s: lb + s + t]
        picks = {}
        for i, (prec, state, table) in enumerate(runs):
            logits, new_state = ref.forward(params, cfg, inputs, state,
                                            cond, s, prec, table)
            runs[i] = (prec, new_state, table)
            picks[prec] = logits if g is None else logits + temperature * g
        best = picks["float32"]
        top = best.max(dim=-1).values
        served_score = best.gather(-1, target[..., None])[..., 0]
        gap = torch.maximum(gap, torch.where(valid, top - served_score,
                                             0.0).max())
        if control:
            choice = picks["fp8"].argmax(dim=-1, keepdim=True)
            cscore = best.gather(-1, choice)[..., 0]
            cgap = torch.maximum(cgap, torch.where(valid, top - cscore,
                                                   0.0).max())
    out = {"gap": float(gap), "tokens": int(lengths.sum())}
    if control:
        out["control_gap"] = float(cgap)
    return out


def waveform_error(wave: torch.Tensor, q_levels: int):
    """(levels the waveform encodes, widest distance of a sample from the
    mu-law value of its level).  The waveform is the program's output; its
    levels are what the reference replays."""
    levels = mulaw.encode(wave, q_levels)
    err = (wave.to(torch.float32) - mulaw.decode(levels, q_levels)).abs()
    return levels, float(err.max()) if err.numel() else 0.0


def control_waveform_error(levels: torch.Tensor, q_levels: int) -> float:
    """The waveform check's control: the mu-law decode computed in bfloat16
    against float32."""
    mu = float(q_levels - 1)
    y = (2.0 * (levels.to(torch.bfloat16) / mu) - 1.0)
    lo = (torch.sign(y) * torch.expm1(torch.abs(y) * torch.log1p(
        torch.tensor(mu, dtype=torch.bfloat16))) / mu).to(torch.float32)
    return float((lo - mulaw.decode(levels, q_levels)).abs().max())

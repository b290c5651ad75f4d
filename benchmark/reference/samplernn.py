"""Plain SampleRNN in float32 PyTorch: the reference the benchmark holds the
port to.

It follows the published model (Mehri et al., "SampleRNN", ICLR 2017, as
samplernn-pytorch builds it): frame tiers from the top down, each a linear
expansion of its input frame plus the upsampled output of the tier above
(and, for a conditioned model, a projection of the conditioning row of the
frame), a stack of GRU (or LSTM) layers and a learned upsampling of the
last layer's state to the tier below; the sample-level MLP embeds the last
``frame_sizes[0]`` levels, adds the bottom tier's row onto its first
hidden layer and maps two ReLU layers to ``q_levels`` logits.  Weights
come as the harness made them, a tree of tensors in the port's layout
(``{"v", "g"}`` for a weight-normed matrix, ``g * v / |v|`` over every
axis but the last).

Departures, each exact in real arithmetic: the embedding and the MLP's
first layer are multiplied out into one table per window position
(``embed @ w_in[j]``), so a window costs gathers instead of a one-hot
product; time is processed in blocks with the recurrent state carried.

``precision="fp8"`` (or ``"int8"``) is the control: every matrix product
takes both of its operands rounded to float8 e4m3 (or int8), one scale per
tensor, and the gradient it passes back in e5m2 (or int8), accumulating in
float32.
"""

from __future__ import annotations

import torch

from benchmark.reference.mulaw import to_float

def full_float32():
    """Float32 products without TF32 on the card (the reference's
    precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


FP8 = {"fp8": (torch.float8_e4m3fn, 448.0),       # values
       "fp8_grad": (torch.float8_e5m2, 57344.0)}   # gradients


def quantize(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as the product will see it: unchanged in float32; otherwise
    with one scale per tensor, rounded to float8 (e4m3 for values,
    ``"fp8"``; e5m2 for gradients, ``"fp8_grad"``: the usual split of
    float8 training) or to the nearest of 255 levels (``"int8"``)."""
    if precision == "float32":
        return t
    amax = t.detach().abs().amax().clamp(min=1e-30)
    if precision == "int8":
        scale = 127.0 / amax
        return torch.round(t * scale).clamp(-127, 127) / scale
    if precision not in FP8:
        raise ValueError(f"precision {precision!r}")
    dtype, top = FP8[precision]
    scale = top / amax
    return (t * scale).to(dtype).to(torch.float32) / scale


GRAD = {"fp8": "fp8_grad", "int8": "int8"}


class _QuantMatMul(torch.autograd.Function):
    """``x @ w`` with both operands quantized, and in the backward pass the
    incoming gradient too (float8: e4m3 values, e5m2 gradients), as a
    training step in that precision computes it."""

    @staticmethod
    def forward(ctx, x, w, precision):
        qx, qw = quantize(x, precision), quantize(w, precision)
        ctx.save_for_backward(qx, qw)
        ctx.precision = precision
        return qx @ qw

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = quantize(g, GRAD[ctx.precision])
        k = qx.shape[-1]
        gw = qx.reshape(-1, k).T @ qg.reshape(-1, qg.shape[-1])
        return qg @ qw.T, gw, None


def mm(x, w, precision: str):
    if precision in GRAD:
        return _QuantMatMul.apply(x, w, precision)
    if precision != "float32":
        raise ValueError(f"precision {precision!r}")
    return x @ w


def resolve(w):
    """A weight-normed ``{"v", "g"}`` matrix as the product uses it."""
    if isinstance(w, dict):
        v, g = w["v"], w["g"]
        axes = tuple(range(v.dim() - 1))
        return g * v / torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True)
                                  + 1e-12)
    return w


def spans(cfg) -> list[int]:
    out, acc = [], 1
    for f in cfg["frame_sizes"]:
        acc *= f
        out.append(acc)
    return out


def lookback(cfg) -> int:
    return spans(cfg)[-1]


def initial_state(params, cfg, batch: int) -> list:
    """Per tier [n_rnn, B, H] (GRU) or [n_rnn, 2, B, H] (LSTM): the
    learned ``h0`` broadcast over the lanes, or zeros."""
    out = []
    for tier in params["tiers"]:
        h = cfg["dim"]
        shape = ((cfg["n_rnn"], batch, h) if cfg["rnn_type"] == "gru"
                 else (cfg["n_rnn"], 2, batch, h))
        dev = tier["b_in"].device
        s = torch.zeros(shape, device=dev)
        if "h0" in tier:
            s = s + tier["h0"].detach()
        out.append(s)
    return out


def reset_lanes(params, cfg, state, resets: torch.Tensor) -> list:
    """``state`` with the lanes flagged in ``resets`` ([B] bool) back at
    their initial state."""
    init = initial_state(params, cfg, resets.shape[0])
    out = []
    for s, s0 in zip(state, init):
        shape = [1] * s.dim()
        shape[-2] = resets.shape[0]
        m = resets.to(s.dtype).view(shape)
        out.append(s0 * m + s * (1.0 - m))
    return out


def _gru(layer, h, xg, precision):
    hg = mm(h, layer["w_hh"], precision) + layer["b_hh"]
    xr, xz, xn = torch.chunk(xg, 3, dim=-1)
    hr, hz, hn = torch.chunk(hg, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _lstm(layer, hc, xg, precision):
    h, c = hc[0], hc[1]
    i, f, g, o = torch.chunk(xg + mm(h, layer["w_hh"], precision)
                             + layer["b_hh"], 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.stack([torch.sigmoid(o) * torch.tanh(c), c])


def _rnn(tier, x, state, rnn_type, precision):
    """x [B, N, H] through the layer stack; returns (h_seq, new state)."""
    step = _gru if rnn_type == "gru" else _lstm
    finals = []
    for i, layer in enumerate(tier["rnn"]):
        xg = mm(x, layer["w_ih"], precision) + layer["b_ih"]
        carry = state[i]
        outs = []
        for t in range(x.shape[1]):
            carry = step(layer, carry, xg[:, t], precision)
            outs.append(carry if rnn_type == "gru" else carry[0])
        x = torch.stack(outs, dim=1)
        finals.append(carry)
    return x, torch.stack(finals)


def cond_rows(cond, n_frames: int, span: int, rate: int, pos0):
    """The conditioning row of each frame: frame j of a tier starts at
    sample ``pos0 + j * span`` and reads row ``start // rate``, clamped to
    the lane's last row.  cond [B, R, D]; pos0 an int."""
    idx = (pos0 + torch.arange(n_frames, device=cond.device) * span) // rate
    return cond[:, idx.clamp(0, cond.shape[1] - 1)]


def mlp_table(params, cfg, precision: str) -> torch.Tensor:
    """``embed @ w_in[j]`` for each window position j: [f1, Q, H]."""
    mlp = params["mlp"]
    f1, e = cfg["frame_sizes"][0], cfg["embed_dim"]
    w_in = resolve(mlp["w_in"])
    w = w_in.reshape(f1, e, w_in.shape[-1])
    return torch.stack([mm(mlp["embed"], w[j], precision)
                        for j in range(f1)])


def forward(params, cfg, inputs, state, cond=None, pos0: int = 0,
            precision: str = "float32", table=None):
    """Teacher-forced logits.

    inputs [B, lookback + T] int levels (T a multiple of lookback): the
    first ``lookback`` are the context before the first target.  state:
    per tier, as ``initial_state``.  cond [B, R, D] (or None): rows of
    ``cond_rate`` samples counted from stream position 0, the first target
    being at stream position ``pos0``.  ``table``: ``mlp_table``'s result,
    to reuse across blocks.  Returns
    (logits [B, T, Q] float32, new state)."""
    lb = lookback(cfg)
    t = inputs.shape[1] - lb
    if t % lb:
        raise ValueError(f"T={t} is not a multiple of {lb}")
    x = to_float(inputs, cfg["q_levels"])
    upper = None
    new_state = [None] * len(params["tiers"])
    for k in range(len(params["tiers"]) - 1, -1, -1):
        tier = params["tiers"][k]
        span = spans(cfg)[k]
        n = t // span
        frames = x[:, lb - span: lb - span + t].reshape(-1, n, span)
        h = mm(frames, resolve(tier["w_in"]), precision) + tier["b_in"]
        if upper is not None:
            h = h + upper
        if cond is not None:
            h = h + mm(cond_rows(cond, n, span, cfg["cond_rate"], pos0),
                       tier["w_cond"], precision)
        h_seq, new_state[k] = _rnn(tier, h, state[k], cfg["rnn_type"],
                                   precision)
        f = cfg["frame_sizes"][k]
        up = mm(h_seq, resolve(tier["w_up"]), precision)
        upper = (up.reshape(h_seq.shape[0], n, f, -1)
                 + tier["b_up"]).reshape(h_seq.shape[0], n * f, -1)
    if table is None:
        table = mlp_table(params, cfg, precision)
    logits = mlp_logits(params, cfg,
                        inputs[:, lb - table.shape[0]: lb + t - 1], upper,
                        table, precision)
    return logits, new_state


def mlp_logits(params, cfg, window_levels, upper, table, precision,
               block: int = 1 << 17):
    """Logits [B, M, Q] of M targets: window_levels [B, M + f1 - 1] the
    levels before each target, upper [B, M, H] the bottom tier's rows."""
    mlp = params["mlp"]
    f1 = table.shape[0]
    b, m = upper.shape[0], upper.shape[1]
    step = max(1, block // max(b, 1))
    outs = []
    lv = window_levels.long()
    for s in range(0, m, step):
        e = min(m, s + step)
        h = upper[:, s:e] + mlp["b_in"]
        for j in range(f1):
            h = h + table[j][lv[:, s + j: e + j]]
        h = torch.relu(h)
        h = torch.relu(mm(h, resolve(mlp["w_h"]), precision) + mlp["b_h"])
        outs.append(mm(h, resolve(mlp["w_out"]), precision) + mlp["b_out"])
    return torch.cat(outs, dim=1)

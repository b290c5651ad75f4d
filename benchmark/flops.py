"""The yardstick's arithmetic: published peaks, the bytes and operations
each kernel needs at its shapes, and the model's FLOPs.

The kernel bounds are a frozen copy of ``chip_smoke.py``'s ``bound``,
``path_bound`` (K1's term) and ``seq_bounds`` and of its training-step
product count; they count what the published architecture needs at the
call's shapes, whatever a kernel reads again.  ``model_flops_per_sample``
counts the model's forward products from its architecture alone: the
embedding is a lookup (no operations) and the MLP's first layer a
product of the f1 embedded samples, so the count does not change when a
route multiplies the embedding into that layer's weights.
"""

from __future__ import annotations

PEAK_BF16 = 989e12      # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
HBM_BYTES = 3.35e12     # bytes/s


def bound(nbytes: float, flops: float):
    """(seconds, what bounds it): the larger of bytes over the memory rate
    and operations over the bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / PEAK_BF16
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def spans(cfg: dict) -> list[int]:
    out, acc = [], 1
    for f in cfg["frame_sizes"]:
        acc *= f
        out.append(acc)
    return out


def k1_bound(cfg: dict, b: int):
    """K1 (``frame_decode``), one bottom frame of f1 samples for b lanes:
    the windows, the rows from the tier, every W' row a B=128 frame's
    windows touch, the MLP's two other matrices and the biases."""
    q, hd, f1 = cfg["q_levels"], cfg["dim"], cfg["frame_sizes"][0]
    return bound(2 * b * f1 * 4 + b * f1 * hd * 4 + f1 * hd * 4
                 + f1 * q * hd * 2 + (hd * hd + hd * q) * 2
                 + (2 * hd + q) * 4, 2.0 * b * f1 * (hd * hd + hd * q))


def seq_bounds(cell: str, n: int, b: int, h: int):
    """K4 (``"gru"``) or K5 (``"lstm"``) over n steps: ((forward s, by),
    (backward s, by)).  Bytes: bf16 weights, x, the stored sequences,
    dh_seq and dx; float32 biases, states, residuals and gradients.
    Operations: the products, 2*B*H*gates*H a step, twice forward and four
    times backward."""
    g, st, res = {"gru": (3, 1, 2), "lstm": (4, 2, 1)}[cell]
    nbh, w = n * b * h, 2 * h * g * h
    fwd_bytes = (2 * nbh + 4 * st * b * h + 2 * w + 4 * 2 * g * h
                 + 2 * (nbh + b * h) + 2 * (st - 1) * nbh + 4 * st * b * h
                 + 4 * res * nbh * g)
    bwd_bytes = (2 * nbh + 4 * b * h + 2 * w + 2 * (nbh + b * h)
                 + 2 * (st - 1) * nbh + 4 * res * nbh * g + 2 * nbh
                 + 4 * st * b * h + 2 * nbh + 4 * st * b * h + 4 * w
                 + 4 * 2 * g * h)
    prod = 2.0 * b * h * g * h
    return bound(fwd_bytes, n * 2 * prod), bound(bwd_bytes, n * 4 * prod)


def k4_step_bound(cfg: dict, b: int, seq_len: int) -> float:
    """Seconds the sequence kernels need in one train step: forward and
    backward of every tier's every layer."""
    cell = cfg["rnn_type"]
    total = 0.0
    for span in spans(cfg):
        fwd, bwd = seq_bounds(cell, seq_len // span, b, cfg["dim"])
        total += cfg["n_rnn"] * (fwd[0] + bwd[0])
    return total


def train_step_flops(cfg: dict, b: int, t: int) -> float:
    """The train step's products as the port computes them (``chip_smoke``'s
    count: three times the forward, whose embedding is a one-hot
    product)."""
    e, hd, f1, q = (cfg["embed_dim"], cfg["dim"], cfg["frame_sizes"][0],
                    cfg["q_levels"])
    fwd = 2.0 * b * t * (f1 * e * hd + hd * hd + hd * q)
    fwd += 2.0 * b * (t + f1 - 1) * q * e
    for k, span in enumerate(spans(cfg)):
        nf = t // span
        fwd += 2.0 * b * nf * (span * hd + 2 * cfg["n_rnn"] * hd * 3 * hd
                               + hd * cfg["frame_sizes"][k] * hd)
    return 3.0 * fwd


def model_flops_per_sample(cfg: dict) -> float:
    """Forward FLOPs of one generated or scored sample: the MLP (its first
    layer over the f1 embedded samples, its hidden layer, its output
    layer), and per tier and per sample its share of one frame's products
    (input expansion, the conditioning projection, the recurrent layers'
    input and state products, the upsampling)."""
    hd, f1, q, e = (cfg["dim"], cfg["frame_sizes"][0], cfg["q_levels"],
                    cfg["embed_dim"])
    gates = {"gru": 3, "lstm": 4}[cfg["rnn_type"]]
    macs = f1 * e * hd + hd * hd + hd * q
    for k, span in enumerate(spans(cfg)):
        frame = (span * hd + cfg.get("cond_dim", 0) * hd
                 + cfg["n_rnn"] * 2 * hd * gates * hd
                 + hd * cfg["frame_sizes"][k] * hd)
        macs += frame / span
    return 2.0 * macs


def mfu_percent(cfg: dict, samples_per_s: float, train: bool) -> float:
    """The whole step's share of the bf16 peak: model FLOPs (three times
    the forward's in training) at the rate given."""
    flops = model_flops_per_sample(cfg) * (3.0 if train else 1.0)
    return 100.0 * flops * samples_per_s / PEAK_BF16

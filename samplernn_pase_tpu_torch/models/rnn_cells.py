"""GRU / LSTM cell math shared by frame tiers, as
``samplernn_pase_tpu.models.rnn_cells``.

GRU gates are r, z, n in the fused weight (the cuDNN order):
    r = sigmoid(x@W_ir + b_ir + h@W_hr + b_hr)
    z = sigmoid(x@W_iz + b_iz + h@W_hz + b_hz)
    n = tanh  (x@W_in + b_in + r * (h@W_hn + b_hn))
    h' = (1 - z) * n + z * h
LSTM gates are i, f, g, o: c' = f*c + i*g; h' = o * tanh(c').
Products run in ``compute_dtype`` with float32 accumulation; gate math and
state stay float32.  ``rnn_scan`` is the plain training scan (the
reference's ``lax.scan``), the route taken without the sequence kernel.
"""

from __future__ import annotations

import torch

from samplernn_pase_tpu_torch.ops import init as winit
from samplernn_pase_tpu_torch.ops.matmul import matmul_f32


def gate_count(rnn_type: str) -> int:
    return {"gru": 3, "lstm": 4}[rnn_type]


def init_rnn_layer(gen: torch.Generator, in_dim: int, hidden: int,
                   rnn_type: str) -> dict:
    g = gate_count(rnn_type)
    w_ih = winit.lecun_uniform(gen, (in_dim, g * hidden), fan_in=in_dim)
    # orthogonal per-gate blocks for the recurrent matrix
    w_hh = torch.cat([winit.orthogonal(gen, (hidden, hidden))
                      for _ in range(g)], dim=1)
    return {"w_ih": w_ih, "w_hh": w_hh,
            "b_ih": torch.zeros(g * hidden), "b_hh": torch.zeros(g * hidden)}


def precompute_inputs(params, x, compute_dtype) -> torch.Tensor:
    """x [..., in_dim] -> input-side gate pre-activations [..., g*H] f32."""
    return matmul_f32(x, params["w_ih"], compute_dtype) + params["b_ih"]


def gru_step(params, h, x_gates, compute_dtype) -> torch.Tensor:
    """One GRU step. h [B,H] f32, x_gates [B,3H] f32 -> h' [B,H]."""
    h_gates = matmul_f32(h, params["w_hh"], compute_dtype) + params["b_hh"]
    xr, xz, xn = torch.chunk(x_gates, 3, dim=-1)
    hr, hz, hn = torch.chunk(h_gates, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def lstm_step(params, hc, x_gates, compute_dtype) -> torch.Tensor:
    """One LSTM step. hc [2,B,H] (h=hc[0], c=hc[1]) -> hc'."""
    h, c = hc[0], hc[1]
    h_gates = matmul_f32(h, params["w_hh"], compute_dtype) + params["b_hh"]
    i, f, g, o = torch.chunk(x_gates + h_gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return torch.stack([h_new, c_new])


def rnn_scan(params, state, x_gates_seq, rnn_type: str,
             compute_dtype) -> tuple:
    """Run one RNN layer over time, differentiated by autograd.

    state [B, H] (gru) or [2, B, H] (lstm); x_gates_seq [B, N, gH] f32.
    Returns (h_seq [B, N, H], final_state)."""
    step = gru_step if rnn_type == "gru" else lstm_step
    carry = state
    outs = []
    for t in range(x_gates_seq.shape[1]):
        carry = step(params, carry, x_gates_seq[:, t], compute_dtype)
        outs.append(carry if rnn_type == "gru" else carry[0])
    return torch.stack(outs, dim=1), carry


def zero_state(batch: int, hidden: int, n_layers: int, rnn_type: str,
               device=None) -> torch.Tensor:
    if rnn_type == "gru":
        return torch.zeros((n_layers, batch, hidden), device=device)
    return torch.zeros((n_layers, 2, batch, hidden), device=device)

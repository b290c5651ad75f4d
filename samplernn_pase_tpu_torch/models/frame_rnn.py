"""Frame-level RNN tier with learned upsampling, as
``samplernn_pase_tpu.models.frame_rnn``: the teacher-forced tier pass
(``tier_apply``) and the decode step (``tier_step``).

The upsampling is the matmul form of ConvTranspose1d(kernel=f, stride=f):
row j of a tier's output is ``h @ w_up[:, j*dim:(j+1)*dim] + b_up[j]``.
"""

from __future__ import annotations

import torch

from samplernn_pase_tpu_torch.models import rnn_cells
from samplernn_pase_tpu_torch.ops import init as winit
from samplernn_pase_tpu_torch.ops import weight_norm as wnorm
from samplernn_pase_tpu_torch.ops.kernels.rnn_train import (
    gru_sequence, lstm_sequence)
from samplernn_pase_tpu_torch.ops.matmul import matmul_dt, matmul_f32, torch_dtype


def init_frame_tier(gen: torch.Generator, span: int, frame_size: int,
                    dim: int, n_rnn: int, rnn_type: str, cond_dim: int,
                    learn_h0: bool, use_weight_norm: bool = False) -> dict:
    """span = raw samples per frame at this tier."""
    maybe_wn = wnorm.make if use_weight_norm else (lambda w: w)
    params = {
        "w_in": maybe_wn(winit.lecun_uniform(gen, (span, dim), fan_in=span)),
        "b_in": torch.zeros(dim),
        "w_up": maybe_wn(winit.lecun_uniform(
            gen, (dim, frame_size * dim), fan_in=dim)),
        "b_up": torch.zeros(frame_size, dim),
        "rnn": [rnn_cells.init_rnn_layer(gen, dim, dim, rnn_type)
                for _ in range(n_rnn)],
    }
    if cond_dim:
        params["w_cond"] = winit.lecun_uniform(gen, (cond_dim, dim),
                                               fan_in=cond_dim)
    if learn_h0:
        params["h0"] = (torch.zeros(n_rnn, 1, dim) if rnn_type == "gru"
                        else torch.zeros(n_rnn, 2, 1, dim))
    return params


def tier_initial_state(params, batch: int, dim: int, n_rnn: int,
                       rnn_type: str, device=None) -> torch.Tensor:
    """Per-lane initial state: learned h0 broadcast over batch, or zeros."""
    if "h0" in params:
        shape = ((n_rnn, batch, dim) if rnn_type == "gru"
                 else (n_rnn, 2, batch, dim))
        h0 = params["h0"]
        return torch.zeros(shape, device=h0.device) + h0
    return rnn_cells.zero_state(batch, dim, n_rnn, rnn_type, device)


def tier_input(params, frames, upper_cond, ext_cond, compute_dtype):
    """Input expansion plus additive conditioning, in compute dtype.

    frames [B, N, span] float; upper_cond [B, N, dim] or None; ext_cond
    [B, N, cond_dim] or None.  Like the reference this adds ``upper_cond``
    in compute dtype (bf16 for the flagship), unlike the decode kernels,
    which add it in float32."""
    dt = torch_dtype(compute_dtype)
    x = (matmul_dt(frames, wnorm.resolve(params["w_in"]), dt)
         + params["b_in"].to(dt))
    if upper_cond is not None:
        x = x + upper_cond.to(dt)
    if ext_cond is not None:
        x = x + matmul_dt(ext_cond, params["w_cond"], dt)
    return x


def tier_rnn(params, x, state, rnn_type: str, compute_dtype,
             use_kernel: bool = False):
    """Run the n_rnn-layer recurrent stack over the frame axis.

    x [B, N, dim]; state [n_rnn, ...] as built by tier_initial_state.
    Returns (h_seq [B, N, dim], new_state).  ``use_kernel`` runs each
    layer through ``gru_sequence`` or ``lstm_sequence`` (the
    whole-sequence kernel and its backward kernel, or their plain versions
    on CPU tensors); otherwise the layer is ``precompute_inputs`` + the
    autograd ``rnn_scan``."""
    seq_fn = gru_sequence if rnn_type == "gru" else lstm_sequence
    h_seq = x
    new_states = []
    for i, layer in enumerate(params["rnn"]):
        if use_kernel:
            hs, final = seq_fn(
                h_seq.transpose(0, 1), state[i], layer["w_ih"],
                layer["b_ih"], layer["w_hh"], layer["b_hh"],
                torch_dtype(compute_dtype))
            h_seq = hs.transpose(0, 1)
        else:
            x_gates = rnn_cells.precompute_inputs(layer, h_seq, compute_dtype)
            h_seq, final = rnn_cells.rnn_scan(layer, state[i], x_gates,
                                              rnn_type, compute_dtype)
        new_states.append(final)
    return h_seq, torch.stack(new_states)


def tier_upsample(params, h_seq, frame_size: int, compute_dtype):
    """h_seq [B, N, dim] -> conditioning [B, N*frame_size, dim] in compute
    dtype (the largest activation of the model; every consumer feeds a
    compute-dtype product)."""
    dt = torch_dtype(compute_dtype)
    b, n, dim = h_seq.shape
    up = matmul_dt(h_seq, wnorm.resolve(params["w_up"]), dt)
    up = up.reshape(b, n, frame_size, dim) + params["b_up"].to(dt)
    return up.reshape(b, n * frame_size, dim)


def tier_apply(params, frames, upper_cond, ext_cond, state, *,
               frame_size: int, rnn_type: str, compute_dtype,
               use_kernel: bool = False):
    """Full teacher-forced tier pass.  Returns (cond_below, new_state)."""
    x = tier_input(params, frames, upper_cond, ext_cond, compute_dtype)
    h_seq, new_state = tier_rnn(params, x, state, rnn_type, compute_dtype,
                                use_kernel)
    return tier_upsample(params, h_seq, frame_size, compute_dtype), new_state


def tier_step(params, frame, upper_cond_vec, ext_cond_vec, state, *,
              frame_size: int, rnn_type: str, compute_dtype):
    """Single-frame step for the generation loop.

    frame [B, span]; upper_cond_vec / ext_cond_vec [B, dim] / [B, cond_dim]
    or None; state [n_rnn, (2,) B, dim].  Returns (cond_below
    [B, frame_size, dim] float32, new_state)."""
    x = tier_input(params, frame[:, None, :],
                   None if upper_cond_vec is None else upper_cond_vec[:, None],
                   None if ext_cond_vec is None else ext_cond_vec[:, None],
                   compute_dtype)[:, 0]
    step = rnn_cells.gru_step if rnn_type == "gru" else rnn_cells.lstm_step
    h = x
    new_states = []
    for i, layer in enumerate(params["rnn"]):
        x_gates = rnn_cells.precompute_inputs(layer, h, compute_dtype)
        new = step(layer, state[i], x_gates, compute_dtype)
        h = new if rnn_type == "gru" else new[0]
        new_states.append(new)
    b, dim = h.shape
    up = matmul_f32(h, wnorm.resolve(params["w_up"]), compute_dtype)
    cond = up.reshape(b, frame_size, dim) + params["b_up"]
    return cond, torch.stack(new_states)

"""The port's plain model modules against the JAX package's, on JAX
parameters carried across by convert.params_from_jax.  float32 at the
logits tolerance of test_torch_oracle.py (atol 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import frame_rnn as jfr
from samplernn_pase_tpu.models import rnn_cells as jrc
from samplernn_pase_tpu.models import sample_mlp as jmlp
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.models import frame_rnn as tfr
from samplernn_pase_tpu_torch.models import rnn_cells as trc
from samplernn_pase_tpu_torch.models import sample_mlp as tmlp
from samplernn_pase_tpu_torch.models import samplernn as tsrnn

ATOL = 2e-4
B = 3


def _params(rnn_type="gru", n_rnn=1, weight_norm=False, seed=0):
    kw = dict(frame_sizes=(4, 2), dim=16, embed_dim=8, rnn_type=rnn_type,
              n_rnn=n_rnn, weight_norm=weight_norm, compute_dtype="float32")
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed),
                                          JCfg(**kw)))
    return JCfg(**kw), TCfg(**kw), jp, convert.params_from_jax(jp)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_cell_steps_match(rnn_type):
    _, _, jp, tp = _params(rnn_type)
    jl, tl = jp["tiers"][0]["rnn"][0], tp["tiers"][0]["rnn"][0]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 16)).astype(np.float32)
    n_state = 1 if rnn_type == "gru" else 2
    h = rng.normal(size=(n_state, B, 16)).astype(np.float32)
    jx = jrc.precompute_inputs(jl, jnp.asarray(x), jnp.float32)
    tx = trc.precompute_inputs(tl, torch.from_numpy(x), "float32")
    _close(tx, jx)
    if rnn_type == "gru":
        want = jrc.gru_step(jl, jnp.asarray(h[0]), jx, jnp.float32)
        got = trc.gru_step(tl, torch.from_numpy(h[0]), tx, "float32")
    else:
        want = jrc.lstm_step(jl, jnp.asarray(h), jx, jnp.float32)
        got = trc.lstm_step(tl, torch.from_numpy(h), tx, "float32")
    _close(got, want)
    for n_layers in (1, 2):
        np.testing.assert_array_equal(
            trc.zero_state(B, 16, n_layers, rnn_type).numpy(),
            np.asarray(jrc.zero_state(B, 16, n_layers, rnn_type)))


@pytest.mark.parametrize("rnn_type,n_rnn,weight_norm", [
    ("gru", 1, False), ("lstm", 1, False), ("gru", 2, True)])
def test_tier_step_matches(rnn_type, n_rnn, weight_norm):
    jc, tc, jp, tp = _params(rnn_type, n_rnn, weight_norm, seed=2)
    rng = np.random.default_rng(3)
    for k in range(jc.n_tiers):
        span = jc.tier_spans[k]
        frame = rng.uniform(-1, 1, (B, span)).astype(np.float32)
        upper = (None if k == jc.n_tiers - 1
                 else rng.normal(size=(B, 16)).astype(np.float32))
        shape = (n_rnn, B, 16) if rnn_type == "gru" else (n_rnn, 2, B, 16)
        state = rng.normal(size=shape).astype(np.float32)
        kw = dict(frame_size=jc.frame_sizes[k], rnn_type=rnn_type)
        jcond, jstate = jfr.tier_step(
            jp["tiers"][k], jnp.asarray(frame),
            None if upper is None else jnp.asarray(upper), None,
            jnp.asarray(state), compute_dtype=jnp.float32, **kw)
        tcond, tstate = tfr.tier_step(
            tp["tiers"][k], torch.from_numpy(frame),
            None if upper is None else torch.from_numpy(upper), None,
            torch.from_numpy(state), compute_dtype="float32", **kw)
        _close(tcond, jcond)
        _close(tstate, jstate)


def test_tier_input_bf16_adds_upper_in_compute_dtype():
    """frame_rnn.tier_input returns compute dtype: in bf16 the reference
    adds ``upper`` in bf16; the port's plain module does the same."""
    _, _, jp, tp = _params()
    rng = np.random.default_rng(4)
    frames = rng.uniform(-1, 1, (B, 2, 8)).astype(np.float32)
    upper = rng.normal(size=(B, 2, 16)).astype(np.float32)
    want = jfr.tier_input(jp["tiers"][1], jnp.asarray(frames),
                          jnp.asarray(upper), None, jnp.bfloat16)
    got = tfr.tier_input(tp["tiers"][1], torch.from_numpy(frames),
                         torch.from_numpy(upper), None, "bfloat16")
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_mlp_step_matches(weight_norm):
    _, _, jp, tp = _params(weight_norm=weight_norm, seed=5)
    rng = np.random.default_rng(6)
    window = rng.integers(0, 256, (B, 4), dtype=np.int32)
    cond = rng.normal(size=(B, 16)).astype(np.float32)
    want = jmlp.mlp_step(jp["mlp"], jnp.asarray(window), jnp.asarray(cond),
                         jnp.float32)
    got = tmlp.mlp_step(tp["mlp"], torch.from_numpy(window),
                        torch.from_numpy(cond), "float32")
    _close(got, want)


def test_initial_state_and_init_shapes():
    jc, tc, jp, tp = _params("lstm", 2)
    tp["tiers"][0]["h0"] = tp["tiers"][0]["h0"] + 0.5
    jp["tiers"][0]["h0"] = jp["tiers"][0]["h0"] + 0.5
    for a, b in zip(jsrnn.initial_state(jp, jc, B),
                    tsrnn.initial_state(tp, tc, B)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the port's own init gives the JAX init's tree, shapes and bounds
    for rnn_type, wn in (("gru", False), ("lstm", True)):
        kw = dict(frame_sizes=(4, 2, 2), dim=16, embed_dim=8,
                  rnn_type=rnn_type, weight_norm=wn, n_speakers=2,
                  cond_dim=4, cond_rate=8)
        own = convert.to_numpy(tsrnn.init_params(
            torch.Generator().manual_seed(0), TCfg(**kw), device="cpu"))
        ref = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(0),
                                               JCfg(**kw)))
        fo, to = jax.tree.flatten(own)
        fr, tr = jax.tree.flatten(ref)
        assert to == tr
        for a, b in zip(fo, fr):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.abs(a).max() <= np.abs(b).max() * 1.5 + 1e-6
    w = tsrnn.init_params(torch.Generator().manual_seed(1),
                          TCfg(frame_sizes=(4, 2), dim=16, embed_dim=8),
                          device="cpu")["tiers"][0]["rnn"][0]["w_hh"]
    for g in range(3):
        blk = w[:, g * 16:(g + 1) * 16]
        torch.testing.assert_close(blk.T @ blk, torch.eye(16), atol=1e-5,
                                   rtol=0)

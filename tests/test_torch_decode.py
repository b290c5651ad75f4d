"""The port's per-frame decode counterparts (plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, float32, with
the same inputs and Gumbel noise made from a seed with numpy.  Samples
must be equal; a flipped argmax is reported with the reference's top-2
logit gap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import frame_rnn as jfr
from samplernn_pase_tpu.models import sample_mlp as jmlp
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.ops.pallas import decode as jdec
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch.ops.kernels import decode as tdec

F1, Q, E, H, B = 4, 256, 8, 16, 4


def _setup(seed):
    cfg = JCfg(frame_sizes=(F1, 2), dim=H, embed_dim=E,
               compute_dtype="float32")
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    window = rng.integers(0, Q, (B, F1), dtype=np.int32)
    noise = rng.gumbel(size=(F1, B, Q)).astype(np.float32)
    return cfg, jp, convert.params_from_jax(jp), rng, window, noise


def _assert_samples(got, want, window, cond, mlp, temp, noise):
    """Equal samples, else the reference's top-2 gap at the first flip."""
    if np.array_equal(got, want):
        return
    b, i = np.argwhere(got != want)[0]
    win = np.concatenate([window, want], axis=1)[:, i:i + F1]
    logits = np.asarray(jmlp.mlp_step(mlp, jnp.asarray(win),
                                      jnp.asarray(cond[:, i]), jnp.float32))
    scores = logits[b] + (temp * noise[i, b] if temp else 0.0)
    top = np.sort(scores)[-2:]
    pytest.fail(f"argmax flip at lane {b} step {i}: got {got[b, i]}, want "
                f"{want[b, i]}, reference top-2 gap {top[1] - top[0]:.3g}")


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_fused_frame_decode_matches_pallas(temp):
    _, jp, tp, rng, window, noise = _setup(1)
    cond = rng.normal(size=(B, F1, H)).astype(np.float32)
    want = np.asarray(jdec.fused_frame_decode(
        jnp.asarray(window), jnp.asarray(cond), temp, jax.random.PRNGKey(0),
        jp["mlp"], q_levels=Q, weights_dtype="float32", interpret=True,
        noise=jnp.asarray(noise)))
    got = tdec.fused_frame_decode(
        torch.from_numpy(window), torch.from_numpy(cond), temp, tp["mlp"],
        q_levels=Q, weights_dtype="float32",
        noise=torch.from_numpy(noise)).numpy()
    _assert_samples(got, want, window, cond, jp["mlp"], temp, noise)


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_fused_tier_frame_decode_matches_pallas(temp):
    _, jp, tp, rng, window, noise = _setup(2)
    upper = rng.normal(size=(B, H)).astype(np.float32)
    h_prev = rng.normal(size=(1, B, H)).astype(np.float32) * 0.5
    want_s, want_h = jdec.fused_tier_frame_decode(
        jnp.asarray(window), jnp.asarray(upper), jnp.asarray(h_prev), temp,
        jax.random.PRNGKey(0), jp["tiers"][0], jp["mlp"], q_levels=Q,
        rnn_type="gru", weights_dtype="float32", interpret=True,
        noise=jnp.asarray(noise))
    got_s, got_h = tdec.fused_tier_frame_decode(
        torch.from_numpy(window), torch.from_numpy(upper),
        torch.from_numpy(h_prev), temp, tp["tiers"][0], tp["mlp"],
        q_levels=Q, weights_dtype="float32", noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)
    # the reference's cond rows for the gap report: tier step from h_prev
    frame = window.astype(np.float32) / (Q / 2) - 1
    cond, _ = jfr.tier_step(jp["tiers"][0], jnp.asarray(frame),
                            jnp.asarray(upper), None, jnp.asarray(h_prev),
                            frame_size=F1, rnn_type="gru",
                            compute_dtype=jnp.float32)
    _assert_samples(got_s.numpy(), np.asarray(want_s), window,
                    np.asarray(cond), jp["mlp"], temp, noise)


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_lstm_fused_tier_frame_decode_matches_pallas(temp):
    """rnn_type="lstm" (the call form of tests/test_pallas.py:146-162):
    equal samples, h and c within 1e-5."""
    cfg = JCfg(frame_sizes=(F1, 2), dim=H, embed_dim=E, rnn_type="lstm",
               compute_dtype="float32")
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(5), cfg))
    tp = convert.params_from_jax(jp)
    rng = np.random.default_rng(5)
    window = rng.integers(0, Q, (B, F1), dtype=np.int32)
    noise = rng.gumbel(size=(F1, B, Q)).astype(np.float32)
    upper = rng.normal(size=(B, H)).astype(np.float32)
    hc = rng.normal(size=(2, B, H)).astype(np.float32) * 0.5
    want_s, want_h = jdec.fused_tier_frame_decode(
        jnp.asarray(window), jnp.asarray(upper), jnp.asarray(hc), temp,
        jax.random.PRNGKey(0), jp["tiers"][0], jp["mlp"], q_levels=Q,
        rnn_type="lstm", weights_dtype="float32", interpret=True,
        noise=jnp.asarray(noise))
    got_s, got_h = tdec.fused_tier_frame_decode(
        torch.from_numpy(window), torch.from_numpy(upper),
        torch.from_numpy(hc), temp, tp["tiers"][0], tp["mlp"], q_levels=Q,
        rnn_type="lstm", weights_dtype="float32",
        noise=torch.from_numpy(noise))
    assert got_h.shape == (2, B, H)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)
    frame = window.astype(np.float32) / (Q / 2) - 1
    cond, _ = jfr.tier_step(jp["tiers"][0], jnp.asarray(frame),
                            jnp.asarray(upper), None, jnp.asarray(hc)[None],
                            frame_size=F1, rnn_type="lstm",
                            compute_dtype=jnp.float32)
    _assert_samples(got_s.numpy(), np.asarray(want_s), window,
                    np.asarray(cond), jp["mlp"], temp, noise)
    with pytest.raises(ValueError, match="rnn_type='gru'"):
        tdec.fused_tier_frame_decode(
            torch.from_numpy(window), torch.from_numpy(upper),
            torch.from_numpy(hc[:1]), temp, tp["tiers"][0], tp["mlp"],
            weights_dtype="float32")


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each wrapper computes its plain version and launches
    nothing."""
    _, _, tp, rng, window, _ = _setup(3)
    tdec.reset_launches()
    tw = tdec.prepare_tier(tp["tiers"][0], torch.float32)
    mw = tdec.prepare_mlp(tp["mlp"], torch.float32, F1)
    h = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
    win = torch.from_numpy(window)
    x = tdec.gemm_bias(win, tw["w_in"], tw["b_in"], h, levels_q=Q)
    torch.testing.assert_close(
        x, tdec.gemm_bias_plain(win, tw["w_in"], tw["b_in"], h, Q))
    lw = tw["layers"][0]
    xg = tdec.gemm_bias(x, lw["w_ih"], lw["b_ih"])
    hg = tdec.gemm_bias(h, lw["w_hh"], lw["b_hh"])
    torch.testing.assert_close(tdec.gru_gates(xg, hg, h),
                               tdec.gru_gates_plain(xg, hg, h))
    g4 = torch.cat([xg, hg[:, :H]], dim=1)
    for a, b in zip(tdec.lstm_gates(g4, h), tdec.lstm_gates_plain(g4, h)):
        torch.testing.assert_close(a, b)
    cond = tdec.gemm_bias(h, tw["w_up"])
    out = torch.zeros((B, 2 * F1), dtype=torch.int32)
    got = tdec.frame_decode(win, cond, tw["b_up"], mw, 0.9, seed=5, pos0=7,
                            out=out[:, F1:])
    assert got.data_ptr() == out[:, F1:].data_ptr()
    torch.testing.assert_close(
        out[:, F1:], tdec.frame_decode_plain(win, cond, tw["b_up"], mw, 0.9,
                                             seed=5, pos0=7))
    assert set(tdec.LAUNCHES.values()) == {0}
    # the fused embedding W' equals embed @ w_in per window slot
    wf = mw["w_fused"].view(F1, Q, H)
    w_in = tp["mlp"]["w_in"].view(F1, E, H)
    for j in range(F1):
        torch.testing.assert_close(wf[j], tp["mlp"]["embed"] @ w_in[j])


def test_greedy_never_reads_noise():
    """T=0 must equal a plain argmax even when the noise holds inf/NaN."""
    _, _, tp, rng, window, noise = _setup(4)
    cond = torch.from_numpy(rng.normal(size=(B, F1 * H)).astype(np.float32))
    mw = tdec.prepare_mlp(tp["mlp"], torch.float32, F1)
    win = torch.from_numpy(window)
    bad = torch.full((F1, B, Q), float("nan"))
    greedy = tdec.frame_decode(win, cond, None, mw, 0.0)
    torch.testing.assert_close(
        tdec.frame_decode(win, cond, None, mw, 0.0, noise=bad), greedy)
    sampled = tdec.frame_decode(win, cond, None, mw, 1.0,
                                noise=torch.from_numpy(noise))
    assert not torch.equal(sampled, greedy)

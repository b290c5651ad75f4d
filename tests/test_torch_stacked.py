"""Stacked RNN tiers (n_rnn > 1), other tier counts and f1 = 1 on the
port's kernel route: the kernels' plain versions on CPU tensors against
the JAX package, float32.

Greedy samples must equal the reference's ``generate_levels`` on both of
its routes (the megakernel or per-frame kernels in interpret mode, and
its XLA path); supplied-noise samples must equal the stacked megakernel's
(``generate_full_pallas(gumbel=...)``) with states within 1e-5.  Within
the port: one call equals chained calls, a stacked pool lane equals its
solo stream, and the launches per top frame are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import generate as jgen
from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.ops.pallas.megagen import generate_full_pallas
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch import generate as tgen
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.models import samplernn as tsrnn
from samplernn_pase_tpu_torch.ops.kernels import decode as tdec
from samplernn_pase_tpu_torch.ops.kernels import megagen as tmega
from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise
from samplernn_pase_tpu_torch.serve import StreamPool


def _model(frame_sizes, seed=0, **kw):
    args = dict(frame_sizes=frame_sizes, dim=16, embed_dim=8,
                compute_dtype="float32", **kw)
    jc, tc = JCfg(**args), TCfg(**args)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, convert.params_from_jax(jp)


def _assert_samples(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not np.array_equal(got, want):
        b, t = np.argwhere(got != want)[0]
        pytest.fail(f"{what}: lane {b} sample {t}: got {got[b, t]}, want "
                    f"{want[b, t]} ({(got != want).mean():.3f} differ)")


# model keywords per case; the reference decodes each on both its routes
# (the megakernel for the 2- and 3-tier stacks, its per-frame kernels for
# 1 and 4 tiers and f1 = 1)
MODELS = {
    "gru_2tier_n_rnn2": dict(frame_sizes=(4, 2), n_rnn=2),
    "lstm_3tier_n_rnn3": dict(frame_sizes=(4, 2, 2), n_rnn=3,
                              rnn_type="lstm"),
    "cond_n_rnn2": dict(frame_sizes=(4, 2), n_rnn=2, cond_dim=6,
                        cond_rate=12),
    "one_tier": dict(frame_sizes=(4,)),
    "four_tiers": dict(frame_sizes=(2, 2, 2, 2)),
    "f1_one": dict(frame_sizes=(1, 4)),
}


@pytest.mark.parametrize("jax_route", ["interpret", False])
@pytest.mark.parametrize("case", sorted(MODELS))
def test_greedy_matches_reference(case, jax_route):
    jc, tc, jp, tp = _model(seed=21, **MODELS[case])
    assert tgen.kernel_scope_error(tc) is None
    b, t = 2, jc.lookback * max(2, 16 // jc.lookback)
    cond = ckw = None
    if jc.cond_dim:
        cond = np.random.default_rng(1).normal(size=(b, 5, 6)).astype(
            np.float32)
        ckw = dict(cond_pos0=np.array([3, 17]))
    want = jgen.generate_levels(
        jp, jc, b, t, None, use_pallas=jax_route,
        **({} if cond is None else dict(
            cond=jnp.asarray(cond),
            cond_pos0=jnp.asarray(ckw["cond_pos0"], jnp.int32))))
    for route in (True, False):
        got = tgen.generate_levels(tp, tc, b, t, None, use_kernels=route,
                                   cond=cond, device="cpu",
                                   **(ckw or {}))
        _assert_samples(got.numpy(), want,
                        f"{case} port route={route} jax={jax_route}")


@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("rnn_type,frame_sizes", [("gru", (4, 2)),
                                                  ("lstm", (4, 2, 2))])
def test_supplied_noise_matches_stacked_megakernel(rnn_type, frame_sizes,
                                                   temp):
    jc, _, jp, tp = _model(frame_sizes, seed=22, n_rnn=2, rnn_type=rnn_type)
    b, n_top, f1 = 2, 3, frame_sizes[0]
    rng = np.random.default_rng(3)
    window = rng.integers(0, 256, (b, jc.lookback), dtype=np.int32)
    lead = (2,) if rnn_type == "gru" else (2, 2)
    states = [rng.normal(size=(*lead, b, 16)).astype(np.float32) * 0.5
              for _ in frame_sizes]
    gum = rng.gumbel(size=(n_top * jc.lookback // f1, f1, b, 256)).astype(
        np.float32)
    blocks, jfin = generate_full_pallas(
        jnp.asarray(window), tuple(jnp.asarray(s) for s in states), temp,
        jnp.int32(0), list(jp["tiers"]), jp["mlp"], n_top=n_top,
        deterministic=not temp, interpret=True, rnn_type=rnn_type,
        weights_dtype="float32", gumbel=jnp.asarray(gum) if temp else None)
    want = np.asarray(jnp.moveaxis(blocks, 0, 1).reshape(b, -1))
    got, tfin = tmega.generate_full(
        torch.from_numpy(window), convert.state_from_jax(states), temp,
        tp["tiers"], tp["mlp"], n_top=n_top, rnn_type=rnn_type,
        weights_dtype="float32",
        gumbel=torch.from_numpy(gum) if temp else None)
    _assert_samples(got.numpy(), want, f"{rnn_type} T={temp}")
    for a, c in zip(tfin, jfin):
        assert a.shape == c.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)


@pytest.mark.parametrize("temp", [None, 0.9])
@pytest.mark.parametrize("case", ["gru_2tier_n_rnn2", "lstm_3tier_n_rnn3",
                                  "f1_one"])
def test_chained_calls_equal_one_call(case, temp):
    """One call equals two chained calls carrying return_state and
    noise_pos0 (the stacked state in the model layout); greedy, the
    reference's own one call too."""
    jc, tc, jp, tp = _model(seed=23, **MODELS[case])
    b, n = 2, jc.lookback * 2
    kw = dict(temperature=temp, seed=5, use_kernels=True, device="cpu")
    one = tgen.generate_levels(tp, tc, b, 2 * n, **kw)
    first, st, hist = tgen.generate_levels(tp, tc, b, n, return_state=True,
                                           **kw)
    lead = (tc.n_rnn,) if tc.rnn_type == "gru" else (tc.n_rnn, 2)
    assert [tuple(s.shape) for s in st] == [(*lead, b, 16)] * tc.n_tiers
    second = tgen.generate_levels(tp, tc, b, n, initial_states=st,
                                  hist=hist, noise_pos0=n, **kw)
    _assert_samples(torch.cat([first, second], 1).numpy(), one.numpy(),
                    f"{case} T={temp}")
    if temp is None:
        want = jgen.generate_levels(jp, jc, b, 2 * n, None,
                                    use_pallas="interpret")
        _assert_samples(one.numpy(), want, f"{case} against the reference")


def test_stacked_pool_lane_equals_solo_stream():
    """A conditioned pool of n_rnn=2 lanes, sampled: a lane's stream equals
    a solo B=1 StreamingGenerator with its key, whoever else is served."""
    _, tc, _, tp = _model((4, 2), seed=24, n_rnn=2, cond_dim=6,
                          cond_rate=12)
    chunk = tc.lookback
    rows = [np.random.default_rng(i).normal(size=(n, 6)).astype(np.float32)
            for i, n in enumerate((5, 3, 7))]
    pool = StreamPool(tp, tc, n_lanes=3, temperature=0.9, seed=7,
                      use_kernels=True, device="cpu")
    outs = []
    for step in range(4):
        if step < 3:
            assert pool.start(cond=rows[step]) == step
        outs.append(pool.emit(chunk * 2))
    for lane in range(3):
        sg = tgen.StreamingGenerator(tp, tc, 1, temperature=0.9,
                                     stream_keys=tnoise.lane_key(7, lane, 0),
                                     use_kernels=True, device="cpu")
        sg.set_cond(rows[lane])
        solo = torch.cat([sg.emit(chunk * 2)[0] for _ in range(4 - lane)])
        got = torch.cat([o[lane] for o in outs[lane:]])
        _assert_samples(got.numpy(), solo.numpy(), f"lane {lane}")


class _Counting:
    """The plain versions behind decode.Ops, counting their calls as the
    wrappers count launches on the card."""

    def __init__(self):
        self.calls = {n: 0 for n in tdec.Ops._fields}

    def ops(self):
        def counted(name, fn):
            def call(*a, **k):
                self.calls[name] += 1
                return fn(*a, **k)
            return call
        return tdec.Ops(*(counted(n, getattr(tdec.PLAIN, n))
                          for n in tdec.Ops._fields))


@pytest.mark.parametrize("rnn_type,frame_sizes,n_rnn,per_top", [
    ("gru", (16, 4), 1, 29), ("gru", (16, 4), 2, 44),
    ("lstm", (16, 4, 4), 1, 121), ("lstm", (16, 4, 4), 2, 184)])
def test_launches_per_top_frame(rnn_type, frame_sizes, n_rnn, per_top):
    """Per top frame a tier step takes 2 + 3 n_rnn kernels and a bottom
    frame one more (K1): 44 for the flagship's shape at n_rnn=2, 184 for
    config 2's."""
    _, tc, _, tp = _model(frame_sizes, seed=25, n_rnn=n_rnn,
                          rnn_type=rnn_type)
    weights = tgen.prepare_weights(tp, tc, "cpu")
    b, n_top = 2, 2
    counting = _Counting()
    states = tsrnn.initial_state(tp, tc, b)
    window = torch.full((b, tc.lookback), 128, dtype=torch.int32)
    tmega.run(weights, window, states, 0.0, n_top, tc.q_levels,
              counting.ops())
    assert sum(counting.calls.values()) == n_top * per_top
    assert counting.calls["frame"] == n_top * tc.lookback // frame_sizes[0]

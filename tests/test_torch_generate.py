"""Whole generation: the port's generate_full (plain versions on the CPU)
against the JAX megakernel in interpret mode, and the port's
generate_levels routes against the JAX XLA path, float32.  Greedy and
supplied-noise samples must be equal and states within 1e-5; Philox
sampling is held within the port (chunking and seeds)."""

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
from samplernn_pase_tpu_torch.ops.kernels import decode as tdec
from samplernn_pase_tpu_torch.ops.kernels import megagen as tmega
from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise

B = 2


def _model(frame_sizes, seed=0, **kw):
    args = dict(frame_sizes=frame_sizes, dim=16, embed_dim=8,
                compute_dtype="float32", **kw)
    jc, tc = JCfg(**args), TCfg(**args)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, convert.params_from_jax(jp)


def _assert_samples(got, want, jp, jc, window, states, temp=0.0, gum=None):
    """Equal samples, else the reference's top-2 teacher-forced logit gap
    at the first flip."""
    if np.array_equal(got, want):
        return
    inputs = jnp.concatenate([jnp.asarray(window), jnp.asarray(want)], 1)
    logits = np.asarray(jsrnn.forward(jp, jc, inputs, states)[0])
    b, t = np.argwhere(got != want)[0]
    f1 = jc.frame_sizes[0]
    scores = logits[b, t] + (temp * gum[t // f1, t % f1, b] if temp else 0)
    top = np.sort(scores)[-2:]
    pytest.fail(f"argmax flip at lane {b} sample {t}: got {got[b, t]}, want "
                f"{want[b, t]}, reference top-2 gap {top[1] - top[0]:.3g}")


@pytest.mark.parametrize("frame_sizes", [(4, 2), (4, 2, 2)])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_generate_full_matches_megakernel(frame_sizes, temp):
    jc, _, jp, tp = _model(frame_sizes, seed=1)
    n_top, lookback, f1 = 3, jc.lookback, frame_sizes[0]
    rng = np.random.default_rng(2)
    window = rng.integers(0, 256, (B, lookback), dtype=np.int32)
    states = [rng.normal(size=(1, B, 16)).astype(np.float32) * 0.5
              for _ in frame_sizes]
    gum = rng.gumbel(size=(n_top * lookback // f1, f1, B, 256)).astype(
        np.float32)
    blocks, jfin = generate_full_pallas(
        jnp.asarray(window), tuple(jnp.asarray(s) for s in states), temp,
        jnp.int32(0), list(jp["tiers"]), jp["mlp"], n_top=n_top,
        deterministic=not temp, interpret=True, rnn_type="gru",
        weights_dtype="float32", gumbel=jnp.asarray(gum) if temp else None)
    want = np.asarray(jnp.moveaxis(blocks, 0, 1).reshape(B, -1))
    got, tfin = tmega.generate_full(
        torch.from_numpy(window), convert.state_from_jax(states), temp,
        tp["tiers"], tp["mlp"], n_top=n_top, weights_dtype="float32",
        gumbel=torch.from_numpy(gum) if temp else None)
    _assert_samples(got.numpy(), want, jp, jc, window,
                    tuple(jnp.asarray(s) for s in states), temp, gum)
    for a, b in zip(tfin, jfin):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("stream_top", [False, True])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_lstm_generate_full_matches_megakernel(stream_top, temp):
    """The 3-tier LSTM (the form of config 2) against the megakernel in its
    resident and top-streamed forms: equal samples, (h, c) within 1e-5."""
    jc, _, jp, tp = _model((4, 2, 2), seed=9, rnn_type="lstm")
    n_top, lookback, f1 = 3, jc.lookback, 4
    rng = np.random.default_rng(10)
    window = rng.integers(0, 256, (B, lookback), dtype=np.int32)
    states = [rng.normal(size=(1, 2, B, 16)).astype(np.float32) * 0.5
              for _ in range(3)]
    gum = rng.gumbel(size=(n_top * lookback // f1, f1, B, 256)).astype(
        np.float32)
    blocks, jfin = generate_full_pallas(
        jnp.asarray(window), tuple(jnp.asarray(s) for s in states), temp,
        jnp.int32(0), list(jp["tiers"]), jp["mlp"], n_top=n_top,
        deterministic=not temp, interpret=True, rnn_type="lstm",
        weights_dtype="float32", stream_top=stream_top,
        gumbel=jnp.asarray(gum) if temp else None)
    want = np.asarray(jnp.moveaxis(blocks, 0, 1).reshape(B, -1))
    got, tfin = tmega.generate_full(
        torch.from_numpy(window), convert.state_from_jax(states), temp,
        tp["tiers"], tp["mlp"], n_top=n_top, rnn_type="lstm",
        weights_dtype="float32",
        gumbel=torch.from_numpy(gum) if temp else None)
    _assert_samples(got.numpy(), want, jp, jc, window,
                    tuple(jnp.asarray(s) for s in states), temp, gum)
    for a, b in zip(tfin, jfin):
        assert a.shape == (1, 2, B, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("route", [True, "frame"])
def test_lstm_generate_levels_greedy_matches_reference(route):
    jc, tc, jp, tp = _model((4, 2, 2), seed=12, rnn_type="lstm")
    t = jc.lookback * 3
    want = np.asarray(jgen.generate_levels(jp, jc, B, t, temperature=None,
                                           use_pallas=False))
    tdec.reset_launches()
    got = tgen.generate_levels(tp, tc, B, t, temperature=None,
                               use_kernels=route, device="cpu").numpy()
    _assert_samples(got, want, jp, jc,
                    np.full((B, jc.lookback), 128, np.int32),
                    jsrnn.initial_state(jp, jc, B))
    assert set(tdec.LAUNCHES.values()) == {0}     # plain versions on CPU


@pytest.mark.parametrize("frame_sizes", [(4, 2), (4, 2, 2)])
@pytest.mark.parametrize("route", [True, "frame", False])
def test_generate_levels_greedy_matches_reference(frame_sizes, route):
    jc, tc, jp, tp = _model(frame_sizes, seed=3)
    t = jc.lookback * 3 - 1          # rounded up, then trimmed
    want = np.asarray(jgen.generate_levels(jp, jc, B, t, temperature=None,
                                           use_pallas=False))
    got = tgen.generate_levels(tp, tc, B, t, temperature=None,
                               use_kernels=route, device="cpu").numpy()
    assert got.shape == (B, t) and got.dtype == np.int32
    _assert_samples(got, want, jp, jc,
                    np.full((B, jc.lookback), 128, np.int32),
                    jsrnn.initial_state(jp, jc, B))


@pytest.mark.parametrize("rnn_type,n_rnn", [("lstm", 2), ("gru", 2)])
def test_plain_route_runs_models_outside_kernel_scope(rnn_type, n_rnn):
    """Stacked tiers, once outside the kernel route's scope: every route
    now equals the reference."""
    jc, tc, jp, tp = _model((4, 2), seed=4, rnn_type=rnn_type, n_rnn=n_rnn)
    t = jc.lookback * 2
    want = np.asarray(jgen.generate_levels(jp, jc, B, t, None,
                                           use_pallas=False))
    assert tgen.kernel_scope_error(tc) is None
    for route in (None, True, "frame"):
        got = tgen.generate_levels(tp, tc, B, t, None, use_kernels=route,
                                   device="cpu").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", [True, "frame", False])
@pytest.mark.parametrize("temp", [None, 0.9])
def test_return_state_carry_equals_one_call(route, temp):
    _, tc, _, tp = _model((4, 2, 2), seed=5)
    n = tc.lookback
    kw = dict(temperature=temp, seed=11, use_kernels=route, device="cpu")
    one = tgen.generate_levels(tp, tc, B, 3 * n, **kw)
    a, st, hist = tgen.generate_levels(tp, tc, B, n, return_state=True,
                                       **kw)
    b = tgen.generate_levels(tp, tc, B, 2 * n, initial_states=st, hist=hist,
                             noise_pos0=n, **kw)
    torch.testing.assert_close(torch.cat([a, b], 1), one, rtol=0, atol=0)


def test_philox_sampling_chunking_and_seeds():
    _, tc, _, tp = _model((4, 2), seed=6)
    t = tc.lookback * 4
    kw = dict(temperature=1.0, use_kernels=True, device="cpu")
    whole = tgen.generate_levels(tp, tc, B, t, seed=1, **kw)
    for chunk in (tc.lookback, 3 * tc.lookback):
        head, st, hist = tgen.generate_levels(tp, tc, B, chunk, seed=1,
                                              return_state=True, **kw)
        tail = tgen.generate_levels(tp, tc, B, t - chunk, seed=1,
                                    initial_states=st, hist=hist,
                                    noise_pos0=chunk, **kw)
        torch.testing.assert_close(torch.cat([head, tail], 1), whole,
                                   rtol=0, atol=0)
    torch.testing.assert_close(tgen.generate_levels(tp, tc, B, t, seed=1,
                                                    **kw), whole)
    other = tgen.generate_levels(tp, tc, B, t, seed=2, **kw)
    assert not torch.equal(other, whole)
    # every route draws the same noise
    for route in ("frame", False):
        torch.testing.assert_close(tgen.generate_levels(
            tp, tc, B, t, seed=1, temperature=1.0, use_kernels=route,
            device="cpu"), whole, rtol=0, atol=0)
    assert 0.999 <= tgen.rescore(tp, tc, whole, 1.0, seed=1) <= 1.0
    assert tgen.rescore(tp, tc, whole, 1.0, seed=2) < 0.5


def test_philox_known_answers_and_noise_layout():
    """Philox4x32-10 known-answer vectors (Random123), and the noise of
    (lane, position, level) taken from word level % 4 of counter
    (level // 4, position, lane)."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = tnoise.philox4x32_10(tuple(torch.tensor([c]) for c in ctr),
                                   key)
        assert tuple(int(g) for g in got) == want
    seed, pos = (7 << 32) | 3, (1 << 32) + 5
    block = tnoise.gumbel_block(seed, 3, pos, 2, 10)
    assert block.shape == (2, 3, 10) and block.dtype == torch.float32
    lane, level = 2, 9
    words = tnoise.philox4x32_10(
        tuple(torch.tensor([c]) for c in
              (level // 4, (pos + 1) & 0xFFFFFFFF, (pos + 1) >> 32, lane)),
        (3, 7))
    want = tnoise.bits_to_gumbel(words[level % 4])
    assert block[1, lane, level] == want[0]
    # the reference's transform, u = m * 2**-23 + 1e-7, below the clamp
    # (megagen.py:417-421); at the largest m it rounds to 1.0f, which the
    # clamp holds at 1 - 2**-24 (ROADMAP.md C)
    m = torch.tensor([0, 1, 0x7FFFFE])
    torch.testing.assert_close(
        tnoise.bits_to_gumbel(m),
        -torch.log(-torch.log(m.to(torch.float32) * 2.0 ** -23 + 1e-7)),
        rtol=0, atol=0)
    top = tnoise.bits_to_gumbel(torch.tensor([0x7FFFFF, 0xFFFFFFFF]))
    want = -torch.log(-torch.log(torch.tensor(1.0 - 2.0 ** -24)))
    assert torch.isfinite(want) and (top == want).all()


def test_noise_finite_for_every_23_bit_word():
    g = tnoise.bits_to_gumbel(torch.arange(1 << 23, dtype=torch.int64))
    assert torch.isfinite(g).all()
    assert g.min() > -3.0 and g.max() < 17.0


def test_make_generator_prepares_weights_once(monkeypatch):
    _, tc, _, tp = _model((4, 2), seed=8)
    calls = []
    prepare = tmega.prepare
    monkeypatch.setattr(tmega, "prepare",
                        lambda *a, **k: calls.append(1) or prepare(*a, **k))
    fn = tgen.make_generator(tc, B, 16, 0.9, use_kernels=True, device="cpu")
    first = fn(tp, seed=3)
    torch.testing.assert_close(fn(tp, seed=3), first, rtol=0, atol=0)
    assert len(calls) == 1
    weights = tgen.prepare_weights(tp, tc, "cpu")
    torch.testing.assert_close(tgen.generate_levels(
        tp, tc, B, 16, 0.9, seed=3, device="cpu", kernel_weights=weights),
        first, rtol=0, atol=0)
    assert len(calls) == 2
    with torch.no_grad():
        tp["mlp"]["b_out"].add_(1.0)      # changed in place: prepared again
    fn(tp, seed=3)
    assert len(calls) == 3
    tgen.make_generator(tc, B, 16, 0.9, use_kernels=False,
                        device="cpu")(tp)
    assert len(calls) == 3


@pytest.mark.parametrize("rnn_type,wrong", [("gru", (1, 2, B, 16)),
                                             ("lstm", (1, B, 16)),
                                             ("lstm", (2, B, 16))])
def test_decode_state_layout_follows_the_tier(rnn_type, wrong):
    """A tier's model-layout state goes to the decode tuple and back
    unchanged, and a state that does not fit the tier's gate count raises
    ValueError before any kernel runs."""
    _, _, _, tp = _model((4, 2), seed=13, rnn_type=rnn_type)
    layers = tdec.prepare_tier(tp["tiers"][0], torch.float32)["layers"]
    shape = (1, B, 16) if rnn_type == "gru" else (1, 2, B, 16)
    s = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    state = tdec.decode_state(s, layers)
    assert len(state) == 1
    assert len(state[0]) == (1 if rnn_type == "gru" else 2)
    torch.testing.assert_close(tdec.model_state(state), s, rtol=0, atol=0)
    with pytest.raises(ValueError, match="takes a state"):
        tmega.generate_full(torch.zeros(B, 8, dtype=torch.int32),
                            (torch.zeros(wrong),) * 2, 0.0, tp["tiers"],
                            tp["mlp"], n_top=1, rnn_type=rnn_type,
                            weights_dtype="float32")


def test_entry_points_and_scope():
    _, tc, _, tp = _model((4, 2), seed=7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgen.generate_levels(tp, tc, B, 8, None)
    # conditioning on a model without cond_dim (or speakers) is refused;
    # per-lane noise and positions run on every route
    for kw in ({"cond": torch.zeros(B, 1, 4)}, {"speakers": [0, 1]}):
        with pytest.raises(ValueError, match="without"):
            tgen.generate_levels(tp, tc, B, 8, None, device="cpu", **kw)
    for kw in ({"lane_keys": np.zeros((B, 2), np.uint32)},
               {"cond_pos0": 3}, {"noise_pos0": np.array([0, 5])}):
        for route in (True, False):
            lv = tgen.generate_levels(tp, tc, B, 8, 0.9, device="cpu",
                                      use_kernels=route, **kw)
            assert lv.shape == (B, 8)
    wave = tgen.generate(tp, tc, B, 10, temperature=0.7, device="cpu")
    assert wave.shape == (B, 10) and wave.abs().max() <= 1.0
    fn = tgen.make_generator(tc, B, 16, None, use_kernels=True,
                             device="cpu")
    torch.testing.assert_close(fn(tp), tgen.generate_levels(
        tp, tc, B, 16, None, device="cpu"))
    empty, st, hist = tgen.generate_levels(tp, tc, B, 0, return_state=True,
                                           device="cpu")
    assert empty.shape == (B, 0) and hist.shape == (B, tc.lookback)
    assert tgen.next_pow2(5) == 8 and tgen.next_pow2(0) == 1
    # stacked tiers run; the megakernel's scope (2 or 3 tiers, f1 >= 2)
    # stays generate_full's, the other configurations decode through
    # generate_levels
    _, _, _, stacked = _model((4, 2), seed=7, n_rnn=2)
    lv, st = tmega.generate_full(torch.zeros(B, 8, dtype=torch.int32),
                                 (torch.zeros(2, B, 16),) * 2, 0.0,
                                 stacked["tiers"], stacked["mlp"], n_top=1,
                                 weights_dtype="float32")
    assert lv.shape == (B, 8) and [s.shape for s in st] == [(2, B, 16)] * 2
    for sizes, why in (((2, 2, 2, 2), "2 or 3 tiers"), ((4,), "2 or 3 tiers"),
                       ((1, 4), "frame_sizes\\[0\\] >= 2")):
        _, tc_, _, p_ = _model(sizes, seed=7)
        assert tgen.kernel_scope_error(tc_) is None
        with pytest.raises(ValueError, match=why):
            tmega.generate_full(
                torch.zeros(B, tc_.lookback, dtype=torch.int32),
                tuple(torch.zeros(1, B, 16) for _ in sizes), 0.0,
                p_["tiers"], p_["mlp"], n_top=1)
    with pytest.raises(ValueError, match="rnn_type='lstm'"):
        tmega.generate_full(torch.zeros(B, 8, dtype=torch.int32),
                            (torch.zeros(1, 2, B, 16),) * 2, 0.0,
                            tp["tiers"], tp["mlp"], n_top=1, rnn_type="lstm")
    assert tdec.KERNELS.frame is tdec.frame_decode

"""Conditioned generation, per-lane noise and prime: the port against the
JAX package, float32 on the CPU.

The port's kernel route (the kernels' plain versions on CPU tensors) is
held against the JAX megakernel in interpret mode, its plain route
against the JAX XLA path: greedy samples must be equal.  Sampled decode
takes JAX's own per-lane noise (``_lane_gumbel_block``) as ``gumbel=``,
since the port's Philox noise cannot reproduce threefry's bits; the
port's per-lane Philox noise is held within the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import generate as jgen
from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.ops.pallas.decode import (
    fused_tier_frame_decode as j_fused_tier)
from samplernn_pase_tpu.ops.pallas.megagen import generate_full_pallas
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch import generate as tgen
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.models import samplernn as tsrnn
from samplernn_pase_tpu_torch.ops.kernels import decode as tdec
from samplernn_pase_tpu_torch.ops.kernels import megagen as tmega
from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise


def _model(seed=0, frame_sizes=(4, 2), cond_rate=12, **kw):
    args = dict(frame_sizes=frame_sizes, dim=16, embed_dim=8, cond_dim=6,
                cond_rate=cond_rate, compute_dtype="float32", **kw)
    jc, tc = JCfg(**args), TCfg(**args)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, convert.params_from_jax(jp)


def _cond(b, rows, seed=1, dim=6):
    return np.random.default_rng(seed).normal(
        size=(b, rows, dim)).astype(np.float32)


def _assert_samples(got, want, what=""):
    """Equal samples, else where the first one differs."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not np.array_equal(got, want):
        b, t = np.argwhere(got != want)[0]
        pytest.fail(f"{what}: lane {b} sample {t}: got {got[b, t]}, want "
                    f"{want[b, t]} ({(got != want).mean():.3f} differ)")


# (cond_rate, cond rows, cond_pos0, speakers): cond_rate 12 does not
# divide the lookback of 8, so lanes sit at different sub-row phases
CASES = {
    "scalar_pos": (12, 10, 5, None),
    "lane_pos": (12, 10, [0, 8, 29], None),
    "short_stream": (8, 3, 0, None),
    "short_lane_pos": (12, 2, [3, 40, 17], None),
    "speakers": (12, 10, [4, 0, 13], [0, 2, 1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route", [True, False])
def test_conditioned_greedy_matches_reference(case, route):
    rate, rows, pos0, spk = CASES[case]
    kw = {"n_speakers": 3} if spk is not None else {}
    jc, tc, jp, tp = _model(seed=3, cond_rate=rate, **kw)
    b, t = 3, jc.lookback * 6
    cond = _cond(b, rows)
    jpos = jnp.asarray(pos0, jnp.int32) if isinstance(pos0, list) else pos0
    jspk = None if spk is None else jnp.asarray(spk, jnp.int32)
    want = jgen.generate_levels(
        jp, jc, b, t, None, cond=jnp.asarray(cond), cond_pos0=jpos,
        speakers=jspk, use_pallas="interpret" if route else False)
    got = tgen.generate_levels(
        tp, tc, b, t, None, cond=cond, cond_pos0=np.asarray(pos0),
        speakers=None if spk is None else np.asarray(spk),
        use_kernels=route, device="cpu")
    _assert_samples(got.numpy(), want, f"{case} route={route}")


@pytest.mark.parametrize("route", [True, False])
def test_conditioned_carry_over_calls_matches_reference(route):
    """A conditioned generation split over calls (return_state, cond_pos0
    advancing by the call lengths, which do not align to cond_rate) equals
    the reference's one call."""
    jc, tc, jp, tp = _model(seed=5)
    b, lb = 2, jc.lookback
    cond = _cond(b, 9, seed=2)
    offs = np.array([0, 7])
    want = jgen.generate_levels(jp, jc, b, lb * 7, None,
                                cond=jnp.asarray(cond),
                                cond_pos0=jnp.asarray(offs, jnp.int32),
                                use_pallas="interpret" if route else False)
    parts, st, hist, done = [], None, None, 0
    for n in (lb * 2, lb, lb * 4):
        lv, st, hist = tgen.generate_levels(
            tp, tc, b, n, None, cond=cond, cond_pos0=offs + done,
            initial_states=st, hist=hist, return_state=True,
            use_kernels=route, device="cpu")
        parts.append(lv)
        done += n
    _assert_samples(torch.cat(parts, 1).numpy(), want, f"route={route}")


def _jax_ext_proj(jp, cond, pos0, rate, n_samples):
    """The reference's per-tier projected rows (``_megagen_chunk``)."""
    b = cond.shape[0]
    pos0 = np.broadcast_to(np.asarray(pos0), (b,))
    need = (n_samples - 1) // rate + 2
    idx = np.clip((pos0 // rate)[:, None] + np.arange(need), 0,
                  cond.shape[1] - 1)
    rows = np.take_along_axis(cond, idx[:, :, None], axis=1)
    ext = [np.moveaxis(rows @ np.asarray(t["w_cond"], np.float32), 0, 1)
           for t in jp["tiers"]]
    return ext, (pos0 % rate).astype(np.int32)


@pytest.mark.parametrize("frame_sizes", [(4, 2), (4, 2, 2)])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_generate_full_conditioned_matches_megakernel(frame_sizes, temp):
    """generate_full's conditioning keywords (cond_rate, ext_proj,
    cond_phase) and supplied per-lane noise against generate_full_pallas:
    equal samples, states within 1e-5."""
    jc, tc, jp, tp = _model(seed=6, frame_sizes=frame_sizes)
    b, n_top, lb, f1 = 3, 3, jc.lookback, frame_sizes[0]
    rng = np.random.default_rng(4)
    window = rng.integers(0, 256, (b, lb), dtype=np.int32)
    states = [rng.normal(size=(1, b, 16)).astype(np.float32) * 0.5
              for _ in frame_sizes]
    cond = _cond(b, 5, seed=7)
    ext, phase = _jax_ext_proj(jp, cond, [0, 8, 29], 12, n_top * lb)
    keys = np.stack([jax.random.PRNGKey(20 + i) for i in range(b)])
    gum = np.array(jgen._lane_gumbel_block(
        jnp.asarray(keys), jnp.asarray([3, 0, 50], jnp.int32), n_top * lb,
        256)).reshape(n_top * lb // f1, f1, b, 256)
    blocks, jfin = generate_full_pallas(
        jnp.asarray(window), tuple(jnp.asarray(s) for s in states), temp,
        jnp.int32(0), list(jp["tiers"]), jp["mlp"], n_top=n_top,
        deterministic=not temp, interpret=True, weights_dtype="float32",
        cond_rate=12, ext_proj=tuple(jnp.asarray(e) for e in ext),
        cond_phase=jnp.asarray(phase),
        gumbel=jnp.asarray(gum) if temp else None)
    want = np.asarray(jnp.moveaxis(blocks, 0, 1).reshape(b, -1))
    got, tfin = tmega.generate_full(
        torch.from_numpy(window), convert.state_from_jax(states), temp,
        tp["tiers"], tp["mlp"], n_top=n_top, weights_dtype="float32",
        cond_rate=12, ext_proj=[torch.from_numpy(e) for e in ext],
        cond_phase=torch.from_numpy(phase),
        gumbel=torch.from_numpy(gum) if temp else None)
    _assert_samples(got.numpy(), want)
    for a, c in zip(tfin, jfin):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)


def test_sampled_lane_noise_matches_reference():
    """Sampled conditioned decode with the reference's per-lane noise: the
    port's kernel loop fed JAX's ``_lane_gumbel_block`` as ``gumbel=``
    equals JAX's ``generate_levels(lane_keys=...)`` on both of its paths,
    with [B] cond and noise positions."""
    jc, tc, jp, tp = _model(seed=8)
    b, t, temp = 3, jc.lookback * 5, 0.8
    cond = _cond(b, 6, seed=3)
    cpos, npos = np.array([0, 5, 30]), np.array([2, 0, 16])
    keys = np.stack([jax.random.PRNGKey(40 + i) for i in range(b)])
    kw = dict(cond=jnp.asarray(cond),
              cond_pos0=jnp.asarray(cpos, jnp.int32),
              lane_keys=jnp.asarray(keys),
              noise_pos0=jnp.asarray(npos, jnp.int32))
    want = np.asarray(jgen.generate_levels(jp, jc, b, t, temp,
                                           use_pallas="interpret", **kw))
    np.testing.assert_array_equal(
        want, np.asarray(jgen.generate_levels(jp, jc, b, t, temp,
                                              use_pallas=False, **kw)))
    f1 = jc.frame_sizes[0]
    gum = np.array(jgen._lane_gumbel_block(
        jnp.asarray(keys), jnp.asarray(npos, jnp.int32), t, 256))
    weights = tgen.prepare_weights(tp, tc, "cpu")
    proj = tgen.project_cond(weights, tc, torch.from_numpy(cond),
                             torch.from_numpy(cpos), t)
    got, _ = tmega.run(
        weights, torch.full((b, jc.lookback), 128, dtype=torch.int32),
        tsrnn.initial_state(tp, tc, b), temp, t // jc.lookback, 256,
        gumbel=torch.from_numpy(gum.reshape(t // f1, f1, b, 256)),
        cond=proj)
    _assert_samples(got.numpy(), want)
    assert len(np.unique(want)) > 8          # really sampled


def test_fused_tier_frame_decode_conditioned_matches_reference():
    """The bottom frame with a conditioning row and per-lane noise against
    the Pallas kernel, which takes the projected row added to ``upper``."""
    jc, tc, jp, tp = _model(seed=9)
    rng = np.random.default_rng(5)
    b, f1 = 3, 4
    window = rng.integers(0, 256, (b, f1), dtype=np.int32)
    upper = rng.normal(size=(b, 16)).astype(np.float32)
    h = rng.normal(size=(1, b, 16)).astype(np.float32) * 0.5
    ext = rng.normal(size=(2, b, 16)).astype(np.float32)   # [R, B, H]
    phase = np.array([0, 11, 6], np.int32)
    pos = 4                                 # lanes 1, 2 bump to row 1
    row = np.where((phase + pos % 12 >= 12)[:, None], ext[1], ext[0])
    keys = np.stack([jax.random.PRNGKey(60 + i) for i in range(b)])
    gum = np.array(jgen._lane_gumbel_block(jnp.asarray(keys), 7, f1, 256))
    for temp in (0.0, 0.9):
        want, jh = j_fused_tier(
            jnp.asarray(window), jnp.asarray(upper + row), jnp.asarray(h),
            temp, jax.random.PRNGKey(0), jp["tiers"][0], jp["mlp"],
            weights_dtype="float32", interpret=True,
            noise=jnp.asarray(gum) if temp else None)
        got, th = tdec.fused_tier_frame_decode(
            torch.from_numpy(window), torch.from_numpy(upper),
            torch.from_numpy(h), temp, tp["tiers"][0], tp["mlp"],
            weights_dtype="float32",
            noise=torch.from_numpy(gum) if temp else None,
            cond=tdec.CondRows(torch.from_numpy(ext),
                               torch.from_numpy(phase), 12), pos=pos)
        _assert_samples(got.numpy(), want, f"T={temp}")
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


def test_gemm_bias_conditioning_epilogue():
    """K2's plain epilogue adds row pos//rate, or the next one (clamped to
    the last) where the lane's phase carries it over, after bias and add;
    a row past the rows given raises."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(4, 5, generator=g)
    w = torch.randn(5, 6, generator=g)
    bias, add = torch.randn(6, generator=g), torch.randn(4, 6, generator=g)
    ext = torch.randn(3, 4, 6, generator=g)
    phase = torch.tensor([0, 3, 9, 5], dtype=torch.int32)
    base = tdec.gemm_bias_plain(a, w, bias, add)
    for pos, rows in ((0, [0, 0, 0, 0]), (7, [0, 1, 1, 1]),
                      (13, [1, 1, 2, 1]), (26, [2, 2, 2, 2])):
        got = tdec.gemm_bias(a, w, bias, add, ext=ext, cphase=phase,
                             pos=pos, cond_rate=10)
        want = base + ext[rows, torch.arange(4)]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="past the 3 rows"):
        tdec.gemm_bias(a, w, ext=ext, cphase=phase, pos=30, cond_rate=10)


def test_lane_noise_is_k1_mode3_and_batch_independent():
    """lane_gumbel_block is K1 mode 3's plain twin; a lane's noise depends
    on its key and positions, not on its index or batch; lane_key gives
    distinct keys per (lane, epoch)."""
    keys = np.stack([tnoise.lane_key(7, lane, 0) for lane in range(4)])
    assert keys.dtype == np.uint32 and len({tuple(k) for k in keys}) == 4
    assert tuple(tnoise.lane_key(7, 1, 1)) != tuple(keys[1])
    assert tuple(tnoise.lane_key(8, 1, 0)) != tuple(keys[1])
    np.testing.assert_array_equal(tnoise.lane_key(7, 2, 0), keys[2])
    pos = torch.tensor([0, 5, 1 << 33, 9])
    block = tnoise.lane_gumbel_block(keys, pos, 3, 10)
    assert block.shape == (3, 4, 10)
    for lane in range(4):
        one = tnoise.lane_gumbel_block(keys[lane:lane + 1], pos[lane:lane + 1],
                                       3, 10)
        torch.testing.assert_close(one[:, 0], block[:, lane], rtol=0, atol=0)
    # position p of the block is word (level % 4) of counter
    # (level // 4, p low, p high, 0) under the lane's key
    lane, i, level = 2, 1, 9
    p = int(pos[lane]) + i
    words = tnoise.philox4x32_10(
        tuple(torch.tensor([c]) for c in
              (level // 4, p & 0xFFFFFFFF, p >> 32, 0)),
        (int(keys[lane][0]), int(keys[lane][1])))
    assert block[i, lane, level] == tnoise.bits_to_gumbel(
        words[level % 4])[0]
    # K1's plain version draws exactly that block in mode 3
    assert torch.equal(tdec.frame_noise(0.9, None, 0, 5, keys,
                                        pos - 5, 4, 3, 10, "cpu"), block)
    _, tc, _, tp = _model(seed=10)
    mw = tdec.prepare_mlp(tp["mlp"], torch.float32, 4)
    g = torch.Generator().manual_seed(4)
    window = torch.randint(0, 256, (4, 4), generator=g, dtype=torch.int32)
    cond = torch.randn(4, 4 * 16, generator=g)
    a = tdec.frame_decode(window, cond, None, mw, 1.0, None, 0, 3,
                          lane_keys=keys, lane_pos=pos)
    b = tdec.frame_decode(window, cond, None, mw, 1.0,
                          tnoise.lane_gumbel_block(keys, pos + 3, 4, 256))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("greedy", [False, True])
def test_lane_keyed_routes_agree_and_split_calls(greedy):
    """Within the port: per-lane Philox noise gives the same samples on
    the kernel and plain routes, split over calls or not, and a lane's
    samples do not depend on the batch it runs in; rescoring with the same
    conditioning and keys agrees."""
    _, tc, _, tp = _model(seed=11, n_speakers=2)
    b, t, temp = 3, tc.lookback * 4, (None if greedy else 1.0)
    cond = _cond(b, 4, seed=6)
    keys = np.stack([tnoise.lane_key(3, lane, 0) for lane in range(b)])
    cpos, npos = np.array([1, 20, 7]), np.array([0, 4, 9])
    kw = dict(cond=cond, cond_pos0=cpos, lane_keys=keys, noise_pos0=npos,
              speakers=np.array([1, 0, 1]), device="cpu")
    whole = tgen.generate_levels(tp, tc, b, t, temp, use_kernels=True, **kw)
    torch.testing.assert_close(tgen.generate_levels(
        tp, tc, b, t, temp, use_kernels=False, **kw), whole, rtol=0, atol=0)
    head, st, hist = tgen.generate_levels(tp, tc, b, tc.lookback, temp,
                                          use_kernels=True,
                                          return_state=True, **kw)
    kw2 = dict(kw, cond_pos0=cpos + tc.lookback, noise_pos0=npos + tc.lookback)
    tail = tgen.generate_levels(tp, tc, b, t - tc.lookback, temp,
                                use_kernels=True, initial_states=st,
                                hist=hist, **kw2)
    torch.testing.assert_close(torch.cat([head, tail], 1), whole, rtol=0,
                               atol=0)
    solo = tgen.generate_levels(
        tp, tc, 1, t, temp, cond=cond[1:2], cond_pos0=cpos[1:2],
        lane_keys=keys[1], noise_pos0=npos[1:2], speakers=np.array([0]),
        use_kernels=True, device="cpu")
    torch.testing.assert_close(solo[0], whole[1], rtol=0, atol=0)
    folded = torch.from_numpy(cond) + tp["speaker"][[1, 0, 1]][:, None]
    assert tgen.rescore(tp, tc, whole, temp, noise_pos0=npos, cond=folded,
                        cond_pos0=cpos, lane_keys=keys) == 1.0
    if not greedy:
        assert tgen.rescore(tp, tc, whole, temp, noise_pos0=npos,
                            cond=folded, cond_pos0=cpos,
                            lane_keys=keys[::-1].copy()) < 0.5


def test_make_generator_conditioned_and_generate():
    _, tc, _, tp = _model(seed=12)
    cond = _cond(2, 5, seed=8)
    fn = tgen.make_generator(tc, 2, 24, 0.9, conditioned=True,
                             use_kernels=True, device="cpu")
    want = tgen.generate_levels(tp, tc, 2, 24, 0.9, seed=4, cond=cond,
                                device="cpu")
    torch.testing.assert_close(fn(tp, 4, cond), want, rtol=0, atol=0)
    wave = tgen.generate(tp, tc, 2, 24, 0.9, seed=4, cond=cond, device="cpu")
    torch.testing.assert_close(wave, tgen.decode_waveform(want, tc))
    with pytest.raises(ValueError, match="cond must be"):
        tgen.generate_levels(tp, tc, 2, 8, None, cond=cond[0], device="cpu")
    with pytest.raises(ValueError, match="lane_keys must be"):
        tgen.generate_levels(tp, tc, 2, 8, 0.9, device="cpu",
                             lane_keys=np.zeros((3, 2), np.uint32))


@pytest.mark.parametrize("case", ["cond", "speakers", "short_seed",
                                  "max_context"])
def test_prime_matches_reference(case):
    """prime's states within 1e-5 and the same window as the reference's,
    conditioned rows aligned to the target window."""
    kw = {"n_speakers": 3} if case == "speakers" else {}
    jc, tc, jp, tp = _model(seed=13, cond_rate=4, **kw)
    rng = np.random.default_rng(9)
    lb = jc.lookback
    total = 3 if case == "short_seed" else lb * 5 + 3
    seed = rng.integers(0, 256, (2, total)).astype(np.int32)
    cond = rng.normal(size=(2, -(-total // 4), 6)).astype(np.float32)
    args = dict(cond=cond)
    if case == "speakers":
        args["speakers"] = np.array([2, 0], np.int32)
    if case == "max_context":
        args["max_context"] = 2 * lb
    js, jh = jgen.prime(jp, jc, jnp.asarray(seed), **args)
    ts, th = tgen.prime(tp, tc, seed, device="cpu", **args)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for a, c in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)


def test_fit_cond_stream_matches_reference():
    rng = np.random.default_rng(3)
    for shape, n in (((5, 4), 8), ((5, 4), 3), ((2, 3, 4), 7), ((1, 4), 1)):
        cond = rng.normal(size=shape).astype(np.float32)
        want = jgen.fit_cond_stream(cond, n)
        got = tgen.fit_cond_stream(torch.from_numpy(cond), n)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="empty conditioning stream"):
        tgen.fit_cond_stream(np.zeros((0, 4), np.float32), 3)

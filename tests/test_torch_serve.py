"""StreamPool: the port's pool lanes against the JAX package's (greedy,
float32) and against the port's solo B=1 StreamingGenerator (greedy and
sampled): a lane's stream must not depend on the other lanes, on when it
joined, or on slot reuse."""

import jax
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import serve as jserve
from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch import generate as tgen
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise
from samplernn_pase_tpu_torch.serve import StreamPool


def _model(seed, **kw):
    args = dict(frame_sizes=(4, 2), dim=16, embed_dim=8,
                compute_dtype="float32", **kw)
    jc, tc = JCfg(**args), TCfg(**args)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, convert.params_from_jax(jp)


def _rows(n, seed, dim=6):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _solo(tp, tc, chunks, cond=None, speaker=None, key=None,
          temperature=None, route=None, extend=None):
    """A solo B=1 stream emitting ``chunks``; ``extend`` = (chunk index,
    longer stream) re-attaches the stream before that chunk."""
    sg = tgen.StreamingGenerator(tp, tc, 1, temperature=temperature,
                                 stream_keys=key, use_kernels=route,
                                 device="cpu")
    if cond is not None:
        sg.set_cond(cond)
    spk = None if speaker is None else np.array([speaker])
    out = []
    for i, n in enumerate(chunks):
        if extend is not None and i == extend[0]:
            sg.set_cond(extend[1])
        out.append(sg.emit(n, speakers=spk)[0])
    return torch.cat(out).numpy()


def _cat(outs, lane, first=0):
    return torch.cat([o[lane] for o in outs[first:]]).numpy()


@pytest.mark.parametrize("route", [True, False])
@pytest.mark.parametrize("rate", [4, 12])
def test_greedy_conditioned_pool_matches_reference_and_solo(rate, route):
    """Per-lane streams and speakers, staggered joins (so, at cond_rate 12,
    lanes at different sub-row phases), one stream short enough to clamp:
    every lane equals the reference pool's lane and the port's solo."""
    jc, tc, jp, tp = _model(1, cond_dim=6, cond_rate=rate, n_speakers=3)
    chunk = jc.lookback
    conds = [_rows(9, 0), _rows(2, 1), _rows(5, 2)]
    spks = [2, 0, 1]
    outs = {}
    for name, pool in (
            ("jax", jserve.StreamPool(jp, jc, n_lanes=3, temperature=None,
                                      use_pallas=("interpret" if route
                                                  else False))),
            ("port", StreamPool(tp, tc, n_lanes=3, temperature=None,
                                use_kernels=route, device="cpu"))):
        lanes, emitted = [], []
        for step in range(6):
            if step < 3:
                lanes.append(pool.start(cond=conds[step],
                                        speaker=spks[step]))
            emitted.append(torch.tensor(np.array(pool.emit(chunk))))
        outs[name] = (lanes, emitted)
    lanes, port = outs["port"]
    assert lanes == outs["jax"][0] == [0, 1, 2]
    for lane in lanes:
        want = _cat(outs["jax"][1], lane, lane)
        np.testing.assert_array_equal(_cat(port, lane, lane), want)
        np.testing.assert_array_equal(
            _solo(tp, tc, [chunk] * (6 - lane), conds[lane], spks[lane],
                  route=route), want)


@pytest.mark.parametrize("route", [True, False])
def test_sampled_lanes_match_solo_and_ignore_churn(route):
    """Sampled lanes (a pinned key, and derived keys lane_key(seed, lane,
    epoch)) equal solo generators with the same keys, and a lane's stream
    does not change when others join, leave or recycle slots."""
    _, tc, _, tp = _model(10, cond_dim=6, cond_rate=12)
    chunk = tc.lookback
    pinned = tnoise.lane_key(99, 0, 0)
    cond_a, cond_b = _rows(4, 3), _rows(2, 4)

    def run(churn):
        pool = StreamPool(tp, tc, n_lanes=3, temperature=0.9, seed=7,
                          use_kernels=route, device="cpu")
        a = pool.start(cond=cond_a, stream_key=pinned)
        outs = [pool.emit(chunk)]
        b = x = None
        if churn:
            b = pool.start(cond=cond_b)
            x = pool.start(cond=cond_b)
        outs.append(pool.emit(chunk))
        if churn:
            pool.stop(x)
            pool.start(cond=cond_a)           # slot recycled, epoch 1
        outs += [pool.emit(chunk * 2) for _ in range(2)]
        return a, b, x, outs

    a, b, x, outs = run(True)
    got_a = _cat(outs, a)
    np.testing.assert_array_equal(got_a, _cat(run(False)[3], a))
    np.testing.assert_array_equal(
        got_a, _solo(tp, tc, [chunk, chunk, 2 * chunk, 2 * chunk], cond_a,
                     key=pinned, temperature=0.9, route=route))
    np.testing.assert_array_equal(
        _cat(outs, b, 1),
        _solo(tp, tc, [chunk, 2 * chunk, 2 * chunk], cond_b,
              key=tnoise.lane_key(7, b, 0), temperature=0.9, route=route))
    np.testing.assert_array_equal(
        _cat(outs, x, 2),
        _solo(tp, tc, [2 * chunk, 2 * chunk], cond_a,
              key=tnoise.lane_key(7, x, 1), temperature=0.9, route=route))
    assert len(np.unique(got_a)) > 4


def test_phase_and_noise_fuzz():
    """Random cond_rates, join times and chunk sizes, sampled: every lane
    equals its solo generator emitting the same chunks from its join."""
    rng = np.random.default_rng(123)
    for trial, rate in enumerate((3, 12)):
        _, tc, _, tp = _model(20 + trial, cond_dim=5, cond_rate=rate)
        conds = [_rows(int(rng.integers(2, 9)), 30 + i, 5) for i in range(3)]
        keys = [tnoise.lane_key(trial, 50 + i, 0) for i in range(3)]
        chunks = [int(c) * tc.lookback for c in rng.integers(1, 4, size=5)]
        pool = StreamPool(tp, tc, n_lanes=3, temperature=0.85,
                          use_kernels=True, device="cpu")
        joined, outs = {}, []
        for step, chunk in enumerate(chunks):
            if step < 3:
                lane = pool.start(cond=conds[step], stream_key=keys[step])
                joined[lane] = step
            outs.append(pool.emit(chunk))
        for lane, s0 in joined.items():
            np.testing.assert_array_equal(
                _cat(outs, lane, s0),
                _solo(tp, tc, chunks[s0:], conds[s0], key=keys[s0],
                      temperature=0.85, route=True),
                err_msg=f"rate={rate} lane={lane} chunks={chunks}")


def test_extend_cond_equals_full_stream_and_grows():
    """A lane started on a prefix and extended mid-stream emits what a
    lane started on the whole stream emits, and what a solo generator
    emits after the same set_cond extension; extension past
    max_cond_frames grows the buffer without touching other lanes."""
    _, tc, _, tp = _model(13, cond_dim=6, cond_rate=12, n_speakers=2)
    chunk = tc.lookback
    full = _rows(11, 5)
    other = _rows(3, 6)

    def run(prefix):
        pool = StreamPool(tp, tc, n_lanes=2, temperature=None,
                          max_cond_frames=4, device="cpu")
        a = pool.start(cond=other, speaker=0)
        lane = pool.start(cond=full[:prefix] if prefix else full, speaker=1)
        outs = [pool.emit(chunk)]
        if prefix:
            pool.extend_cond(lane, full[prefix:])
            assert pool._f_cap >= 11
        outs += [pool.emit(chunk) for _ in range(11)]
        return _cat(outs, lane), _cat(outs, a)

    ext, a_ext = run(2)
    whole, a_whole = run(0)
    np.testing.assert_array_equal(ext, whole)
    np.testing.assert_array_equal(a_ext, a_whole)
    np.testing.assert_array_equal(
        ext, _solo(tp, tc, [chunk] * 12, full[:2], speaker=1,
                   extend=(1, full)))
    np.testing.assert_array_equal(
        a_ext, _solo(tp, tc, [chunk] * 12, other, speaker=0))


def test_slot_reuse_is_fresh():
    """A recycled slot restarts its state, window, cursor and stream."""
    _, tc, _, tp = _model(7, cond_dim=6, cond_rate=4)
    chunk = 2 * tc.lookback
    pool = StreamPool(tp, tc, n_lanes=1, temperature=None, device="cpu")
    a = pool.start(cond=_rows(12, 8))
    for _ in range(3):
        pool.emit(chunk)
    pool.stop(a)
    b = pool.start(cond=_rows(9, 9))
    assert b == a
    got = torch.cat([pool.emit(chunk)[b] for _ in range(2)]).numpy()
    np.testing.assert_array_equal(got, _solo(tp, tc, [chunk] * 2,
                                             _rows(9, 9)))


def test_seed_join_matches_prime():
    _, tc, _, tp = _model(3, cond_dim=6, cond_rate=4)
    chunk = 2 * tc.lookback
    rng = np.random.default_rng(1)
    seed = rng.integers(0, 256, (1, 4 * tc.lookback))
    seed_cond, cond = _rows(8, 10), _rows(6, 11)
    pool = StreamPool(tp, tc, n_lanes=2, temperature=None, device="cpu")
    pool.start(cond=_rows(3, 12))             # other traffic in lane 0
    pool.emit(chunk)
    j = pool.start(cond=cond, seed_levels=seed[0], seed_cond=seed_cond)
    got = pool.emit(chunk)[j]
    st, hist = tgen.prime(tp, tc, seed, cond=seed_cond[None], device="cpu")
    want = tgen.generate_levels(tp, tc, 1, chunk, None, cond=cond[None],
                                initial_states=st, hist=hist, device="cpu")
    torch.testing.assert_close(got, want[0], rtol=0, atol=0)


def test_rejected_start_does_not_leak_the_lane():
    _, tc, _, tp = _model(8, cond_dim=6, cond_rate=4)
    pool = StreamPool(tp, tc, n_lanes=1, temperature=None, device="cpu")
    cond = np.zeros((4, 6), np.float32)
    with pytest.raises(ValueError, match="seed_cond"):
        pool.start(cond=cond, seed_levels=np.zeros(16, np.int64),
                   seed_cond=np.zeros((3, 5), np.float32))
    with pytest.raises(ValueError, match="seed_levels"):
        pool.start(cond=cond, seed_levels=np.zeros((2, 16), np.int64))
    with pytest.raises(ValueError, match="greedy"):
        pool.start(cond=cond, stream_key=tnoise.lane_key(0, 0, 0))
    lane = pool.start(cond=cond)
    assert lane == 0 and pool.active == {0}


def test_pool_validation_errors():
    _, tc, _, tp = _model(5, cond_dim=6, cond_rate=3, n_speakers=2)
    pool = StreamPool(tp, tc, n_lanes=1, temperature=None, device="cpu")
    with pytest.raises(ValueError, match="cond"):
        pool.start(speaker=0)
    cond = np.zeros((4, 6), np.float32)
    with pytest.raises(ValueError, match="speaker"):
        pool.start(cond=cond)
    with pytest.raises(ValueError, match="out of range"):
        pool.start(cond=cond, speaker=5)
    with pytest.raises(ValueError, match="seed_cond"):
        pool.start(cond=cond, speaker=0,
                   seed_cond=np.zeros((2, 6), np.float32))
    assert not pool.active and len(pool._free) == 1
    lane = pool.start(cond=cond, speaker=1)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.start(cond=cond, speaker=0)
    with pytest.raises(ValueError, match="already active"):
        pool.start(cond=cond, speaker=0, lane=lane)
    assert pool.emit(tc.lookback).shape == (1, tc.lookback)
    with pytest.raises(ValueError, match="rows"):
        pool.extend_cond(lane, np.zeros((2, 5), np.float32))
    pool.stop(lane)
    with pytest.raises(ValueError, match="not active"):
        pool.stop(lane)
    with pytest.raises(ValueError, match="not active"):
        pool.extend_cond(lane, cond)
    _, utc, _, utp = _model(6)
    upool = StreamPool(utp, utc, n_lanes=2, temperature=0.9, device="cpu")
    with pytest.raises(ValueError, match="unconditioned"):
        upool.start(cond=cond)
    with pytest.raises(ValueError, match="cond_dim"):
        upool.extend_cond(0, cond)
    with pytest.raises(ValueError, match=r"\[2\] uint32"):
        upool.start(stream_key=np.zeros(3, np.uint32))
    upool.start()
    with pytest.raises(ValueError, match="multiple of lookback"):
        upool.emit(3)
    w = upool.emit_waveform(utc.lookback)
    assert w.shape == (2, utc.lookback) and w.abs().max() <= 1.0

"""StreamingGenerator: the port's chunked stateful decode against the JAX
package's (greedy, float32, both routes), and its own invariants (sampled
streams do not depend on chunking or buffering; the guards raise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import generate as jgen
from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch import generate as tgen
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise

# cond_rate 6 does not divide the lookback of 8: chunk boundaries land
# mid-row, which the cursor's per-lane phase has to carry
CCFG = dict(frame_sizes=(4, 2), dim=16, embed_dim=8, cond_dim=6,
            cond_rate=6, n_speakers=3, compute_dtype="float32")
UCFG = dict(frame_sizes=(4, 2), dim=16, embed_dim=8, compute_dtype="float32")
ROUTES = {True: "interpret", False: False}


def _model(args, seed):
    jc, tc = JCfg(**args), TCfg(**args)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, convert.params_from_jax(jp)


def _stream(n_rows, seed=7, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, n_rows, 6)).astype(np.float32)


def _emit_all(sg, chunks, **kw):
    return np.concatenate([np.asarray(sg.emit(n, **kw)) for n in chunks],
                          axis=1)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("route", [True, False])
def test_cond_stream_greedy_matches_reference(route, k):
    """set_cond + chunked greedy emits with speakers, direct and buffered,
    equal the reference's StreamingGenerator and its one-shot decode;
    the stream is short enough to clamp past its end."""
    jc, tc, jp, tp = _model(CCFG, 6)
    lb = jc.lookback
    cond = _stream(5)                 # 30 samples of rows for 48 decoded
    spk = np.array([0, 2], np.int32)
    js = jgen.StreamingGenerator(jp, jc, 2, temperature=None,
                                 use_pallas=ROUTES[route],
                                 chunks_per_call=k)
    js.set_cond(cond)
    want = _emit_all(js, [lb * 2] * 3, speakers=spk)
    np.testing.assert_array_equal(want, np.asarray(jgen.generate_levels(
        jp, jc, 2, lb * 6, None, cond=jnp.asarray(cond),
        speakers=jnp.asarray(spk), use_pallas=ROUTES[route])))
    ts = tgen.StreamingGenerator(tp, tc, 2, temperature=None,
                                 use_kernels=route, chunks_per_call=k,
                                 device="cpu")
    ts.set_cond(cond)
    np.testing.assert_array_equal(
        _emit_all(ts, [lb * 2] * 3, speakers=spk), want)


@pytest.mark.parametrize("route", [True, False])
def test_progressive_extension_matches_reference(route):
    """Extending the stream mid-decode with pending lookahead, twice, as
    the reference does; the result equals attaching the whole stream."""
    args = dict(CCFG, cond_rate=4, n_speakers=0)
    jc, tc, jp, tp = _model(args, 1)
    full = np.random.default_rng(1).normal(size=(24, 6)).astype(np.float32)
    lb = jc.lookback
    outs = []
    for mod, p, kw in ((jgen, jp, {"use_pallas": ROUTES[route]}),
                       (tgen, tp, {"use_kernels": route, "device": "cpu"})):
        sg = mod.StreamingGenerator(p, jc if mod is jgen else tc, 1,
                                    temperature=None, chunks_per_call=2,
                                    **kw)
        sg.set_cond(full[:8])
        got = [np.asarray(sg.emit(lb))]
        assert sg.pending > 0
        sg.set_cond(full[:16])
        got.append(np.asarray(sg.emit(lb)))
        sg.set_cond(full)
        got += [np.asarray(sg.emit(lb)) for _ in range(4)]
        outs.append(np.concatenate(got, axis=1))
    np.testing.assert_array_equal(outs[1], outs[0])
    whole = tgen.StreamingGenerator(tp, tc, 1, temperature=None,
                                    use_kernels=route, device="cpu")
    whole.set_cond(full)
    np.testing.assert_array_equal(_emit_all(whole, [lb] * 6), outs[0])


@pytest.mark.parametrize("route", [True, False])
def test_primed_stream_matches_reference(route):
    """prime then emit, conditioned: the reference's stream, and the port's
    one-shot generation from prime's state."""
    jc, tc, jp, tp = _model(CCFG, 2)
    lb = jc.lookback
    rng = np.random.default_rng(4)
    seed = rng.integers(0, 256, (2, lb * 4)).astype(np.int32)
    seed_cond = rng.normal(size=(2, 6, 6)).astype(np.float32)
    cond = _stream(8, seed=5)
    spk = np.array([1, 2], np.int32)
    js = jgen.StreamingGenerator(jp, jc, 2, temperature=None,
                                 use_pallas=ROUTES[route])
    js.prime(jnp.asarray(seed), cond=jnp.asarray(seed_cond),
             speakers=jnp.asarray(spk))
    js.set_cond(cond)
    want = _emit_all(js, [lb * 2] * 2, speakers=spk)
    ts = tgen.StreamingGenerator(tp, tc, 2, temperature=None,
                                 use_kernels=route, device="cpu")
    ts.prime(seed, cond=seed_cond, speakers=spk)
    ts.set_cond(cond)
    np.testing.assert_array_equal(_emit_all(ts, [lb * 2] * 2, speakers=spk),
                                  want)
    st, hist = tgen.prime(tp, tc, seed, cond=seed_cond, speakers=spk,
                          device="cpu")
    np.testing.assert_array_equal(np.asarray(tgen.generate_levels(
        tp, tc, 2, lb * 4, None, cond=cond, speakers=spk, initial_states=st,
        hist=hist, use_kernels=route, device="cpu")), want)


def test_unconditioned_stream_matches_reference_and_reset():
    jc, tc, jp, tp = _model(UCFG, 0)
    lb = jc.lookback
    want = np.asarray(jgen.generate_levels(jp, jc, 2, lb * 6, None,
                                           use_pallas=False))
    ts = tgen.StreamingGenerator(tp, tc, 2, temperature=None, device="cpu")
    np.testing.assert_array_equal(_emit_all(ts, [lb * 2] * 3), want)
    ts.reset()
    np.testing.assert_array_equal(_emit_all(ts, [lb * 3] * 2), want)
    with pytest.raises(ValueError, match="multiple of lookback"):
        ts.emit(lb + 1)
    w = ts.emit_waveform(lb * 2)
    assert w.shape == (2, lb * 2) and w.abs().max() <= 1.0


@pytest.mark.parametrize("keyed", [True, False])
def test_sampled_stream_invariant_to_chunking_and_buffering(keyed):
    """Noise is a pure function of (key, lane, position): with per-lane
    stream_keys or the shared seed, sampled streams are the same for any
    chunks_per_call, for any chunking, and as one call; the kernel and
    plain routes agree; reset() gives the fresh stream again."""
    _, tc, _, tp = _model(CCFG, 3)
    lb = tc.lookback
    keys = np.stack([tnoise.lane_key(11, lane, 0) for lane in range(2)])
    skw = {"stream_keys": keys} if keyed else {"seed": 5}
    cond = _stream(12, seed=6)
    spk = np.array([2, 0])

    def collect(k, chunks, route=True):
        sg = tgen.StreamingGenerator(tp, tc, 2, temperature=0.9,
                                     chunks_per_call=k, use_kernels=route,
                                     device="cpu", **skw)
        sg.set_cond(cond)
        return _emit_all(sg, chunks, speakers=spk)

    ref = collect(1, [lb * 2] * 6)
    np.testing.assert_array_equal(collect(3, [lb * 2] * 6), ref)
    np.testing.assert_array_equal(collect(4, [lb, lb * 3, lb * 2] * 2), ref)
    np.testing.assert_array_equal(collect(1, [lb * 2] * 6, False), ref)
    oneshot = tgen.generate_levels(
        tp, tc, 2, lb * 12, 0.9, seed=0 if keyed else 5, cond=cond,
        speakers=spk, lane_keys=keys if keyed else None, device="cpu")
    np.testing.assert_array_equal(oneshot.numpy(), ref)
    assert len(np.unique(ref)) > 8
    sg = tgen.StreamingGenerator(tp, tc, 2, temperature=0.9, device="cpu",
                                 **skw)
    sg.set_cond(cond)
    first = _emit_all(sg, [lb * 2], speakers=spk)
    sg.reset()
    np.testing.assert_array_equal(_emit_all(sg, [lb * 2], speakers=spk),
                                  first)


def test_buffered_rejects_stale_cond_and_speaker_switch():
    """Buffered lookahead cannot honour a cond or speaker change."""
    _, tc, _, tp = _model(dict(CCFG, cond_rate=8), 5)
    lb = tc.lookback
    sg = tgen.StreamingGenerator(tp, tc, 2, temperature=None,
                                 chunks_per_call=4, device="cpu")
    sg.emit(lb, speakers=np.array([0, 1]))          # fills lookahead
    with pytest.raises(ValueError, match="pending lookahead"):
        sg.emit(lb, cond=np.zeros((2, 1, 6), np.float32))
    with pytest.raises(ValueError, match="speakers"):
        sg.emit(lb, speakers=np.array([2, 2]))
    assert sg.emit(lb, speakers=np.array([0, 1])).shape == (2, lb)
    # a per-chunk cond with no lookahead pending takes the direct path
    cond = _stream(2, seed=9)
    a = tgen.StreamingGenerator(tp, tc, 2, temperature=None,
                                chunks_per_call=4, device="cpu")
    b = tgen.StreamingGenerator(tp, tc, 2, temperature=None, device="cpu")
    torch.testing.assert_close(a.emit(lb * 2, cond=cond),
                               b.emit(lb * 2, cond=cond), rtol=0, atol=0)


def test_set_cond_validation_and_broadcast():
    _, tc, _, tp = _model(CCFG, 6)
    lb = tc.lookback
    cond = _stream(3)
    spk = np.array([1, 1])
    a = tgen.StreamingGenerator(tp, tc, 2, temperature=None, device="cpu")
    a.set_cond(cond[0])
    b = tgen.StreamingGenerator(tp, tc, 2, temperature=None, device="cpu")
    b.set_cond(np.broadcast_to(cond[0][None], cond.shape))
    torch.testing.assert_close(a.emit(lb * 2, speakers=spk),
                               b.emit(lb * 2, speakers=spk), rtol=0, atol=0)
    with pytest.raises(ValueError, match="set_cond expects"):
        a.set_cond(np.zeros((3, 4, 6), np.float32))
    with pytest.raises(ValueError, match="empty"):
        a.set_cond(np.zeros((0, 6), np.float32))
    _, utc, _, utp = _model(UCFG, 6)
    with pytest.raises(ValueError, match="without cond_dim"):
        tgen.StreamingGenerator(utp, utc, 1, device="cpu").set_cond(cond[0])
    with pytest.raises(ValueError, match="empty conditioning stream"):
        tgen.fit_cond_stream(np.zeros((0, 4), np.float32), 3)


def test_set_cond_rejects_pending_lookahead():
    _, tc, _, tp = _model(dict(CCFG, cond_rate=4, n_speakers=0), 0)
    rng = np.random.default_rng(0)
    sg = tgen.StreamingGenerator(tp, tc, 1, temperature=None,
                                 chunks_per_call=2, device="cpu")
    sg.set_cond(rng.normal(size=(16, 6)).astype(np.float32))
    sg.emit(tc.lookback)                    # leaves lookahead pending
    with pytest.raises(ValueError, match="pending lookahead"):
        sg.set_cond(rng.normal(size=(16, 6)).astype(np.float32))
    sg.reset()
    sg.set_cond(rng.normal(size=(16, 6)).astype(np.float32))   # ok now

"""serve.run_jobs: continuous-batching synthesis over a manifest, the
port's against the JAX package's (greedy, float32: sample for sample) and
against the port's solo B=1 streams (sampled, pinned stream keys: bit for
bit).  Also: enqueue-ahead changes nothing, ``retain_results=False`` keeps
no audio, and a bad manifest raises before any job runs."""

import jax
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import serve as jserve
from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch import generate as tgen
from samplernn_pase_tpu_torch import serve as tserve
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key

STATS = {"jobs", "chunks", "chunk", "lanes", "generated", "dispatched",
         "utilization", "wall_s"}


def _model(seed, **kw):
    args = dict(frame_sizes=(4, 2), dim=16, embed_dim=8,
                compute_dtype="float32", **kw)
    jc, tc = JCfg(**args), TCfg(**args)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, convert.params_from_jax(jp)


def _rows(n, seed, dim=6):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _manifests(case):
    """(model kwargs, chunk multiple, jobs) of the reference's run_jobs
    tests: varied lengths (two trimmed) on 2 lanes; conditioned jobs with
    speakers at their natural length, one continuing a prompt."""
    if case == "lengths":
        return {}, 1, [{"id": f"j{i}", "n_samples": n}
                       for i, n in enumerate([24, 8, 19, 40, 3])]
    rate = 4 if case == "cond_rate4" else 12
    conds = [_rows(f, 5 + f) for f in (6, 2, 10, 7)]
    jobs = [{"id": k, "cond": c, "speaker": k % 3}
            for k, c in enumerate(conds)]
    jobs[3].update(seed_levels=np.random.default_rng(1).integers(
        0, 256, 24), seed_cond=_rows(3, 2))
    return dict(cond_dim=6, cond_rate=rate, n_speakers=3), 2, jobs


@pytest.mark.parametrize("route", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("case", ["lengths", "cond_rate4", "cond_rate12"])
def test_greedy_jobs_match_reference(case, route):
    kw, mult, jobs = _manifests(case)
    jc, tc, jp, tp = _model(20, **kw)
    chunk = jc.lookback * mult
    done = []
    want, wstats = jserve.run_jobs(jp, jc, jobs, n_lanes=2, chunk=chunk,
                                   temperature=None)
    got, stats = tserve.run_jobs(tp, tc, jobs, n_lanes=2, chunk=chunk,
                                 temperature=None, use_kernels=route,
                                 device="cpu",
                                 on_done=lambda jid, lv: done.append(jid))
    assert set(got) == set(want) and sorted(done, key=str) == sorted(
        got, key=str)
    for jid, lv in got.items():
        assert lv.dtype == np.int32 and lv.shape == want[jid].shape
        np.testing.assert_array_equal(lv, np.asarray(want[jid]))
    assert set(stats) == set(wstats) == STATS
    for key in STATS - {"wall_s"}:
        assert stats[key] == wstats[key], key
    if case != "lengths":   # natural length: cond rows x cond_rate
        assert got[1].shape == (2 * tc.cond_rate,)


def _solo(tp, tc, n, chunk, key, temperature, cond=None):
    sg = tgen.StreamingGenerator(tp, tc, 1, temperature=temperature,
                                 stream_keys=key, device="cpu")
    if cond is not None:
        sg.set_cond(cond)
    return torch.cat([sg.emit(chunk)[0]
                      for _ in range(-(-n // chunk))]).numpy()[:n]


def _sampled_jobs(tc, chunk):
    return [{"id": i, "n_samples": (i % 3 + 1) * chunk - i,
             "cond": _rows(2 + i, 30 + i),
             "stream_key": lane_key(100 + i, 0, 0)} for i in range(5)]


def test_sampled_stream_keys_match_solo():
    """Pinned keys make each job a pure function of its key, whatever
    lane and order the scheduler gave it."""
    _, tc, _, tp = _model(21, cond_dim=6, cond_rate=12)
    chunk = tc.lookback * 2
    jobs = _sampled_jobs(tc, chunk)
    got, _ = tserve.run_jobs(tp, tc, jobs, n_lanes=2, chunk=chunk,
                             temperature=0.9, seed=1, device="cpu")
    for job in jobs:
        want = _solo(tp, tc, job["n_samples"], chunk, job["stream_key"], 0.9,
                     job["cond"])
        np.testing.assert_array_equal(got[job["id"]], want)
    assert len(np.unique(np.concatenate(list(got.values())))) > 8


def test_enqueue_ahead_and_retain_results_change_no_sample():
    _, tc, _, tp = _model(23, cond_dim=6, cond_rate=12)
    chunk = tc.lookback
    jobs = _sampled_jobs(tc, chunk) + [{"id": "derived", "n_samples": 40,
                                        "cond": _rows(3, 9)}]
    kw = dict(n_lanes=2, chunk=chunk, temperature=1.1, seed=2, device="cpu")
    a, _ = tserve.run_jobs(tp, tc, jobs, enqueue_ahead=True, **kw)
    b, _ = tserve.run_jobs(tp, tc, jobs, enqueue_ahead=False, **kw)
    streamed = {}
    c, stats = tserve.run_jobs(tp, tc, jobs, retain_results=False,
                               on_done=streamed.__setitem__, **kw)
    assert c == {} and set(a) == set(b) == set(streamed)
    for jid in a:
        np.testing.assert_array_equal(a[jid], b[jid])
        np.testing.assert_array_equal(a[jid], streamed[jid])
    assert 0 < stats["utilization"] <= 1 and stats["generated"] == sum(
        len(v) for v in a.values())


BAD = {
    "n_samples_missing": ({"id": "b"}, {}, "n_samples is required"),
    "n_samples_zero": ({"id": "b", "n_samples": 0}, {}, ">= 1"),
    "greedy_stream_key": ({"id": "b", "n_samples": 8,
                           "stream_key": lane_key(1, 0, 0)},
                          {"temperature": None}, "greedy"),
    "bad_stream_key": ({"id": "b", "n_samples": 8,
                        "stream_key": np.zeros(3, np.uint32)}, {},
                       r"\[2\] uint32"),
    "seed_cond_alone": ({"id": "b", "n_samples": 8,
                         "seed_cond": np.zeros((2, 6), np.float32)}, {},
                        "seed_cond without seed_levels"),
    "duplicate_id": ({"id": "a", "n_samples": 8}, {}, "unique"),
    "chunk": ({"id": "b", "n_samples": 8}, {"chunk": 3}, "multiple of"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_manifest_raises_before_any_job(case):
    bad, kw, match = BAD[case]
    _, tc, _, tp = _model(24)
    fired = []
    with pytest.raises(ValueError, match=match):
        tserve.run_jobs(tp, tc, [{"id": "a", "n_samples": 8}, bad],
                        n_lanes=1, device="cpu",
                        on_done=lambda jid, lv: fired.append(jid),
                        **{"temperature": 1.0, **kw})
    assert fired == []


def test_empty_manifest_and_host_copy():
    _, tc, _, tp = _model(25)
    results, stats = tserve.run_jobs(tp, tc, [], n_lanes=2, device="cpu")
    assert results == {} and stats["chunks"] == 0
    assert stats["utilization"] == 0.0
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    np.testing.assert_array_equal(tserve.host_wait(tserve.host_copy(x)),
                                  x.numpy())

"""The port's mesh paths, mirroring ``tests/test_parallel.py`` test for
test: each scenario runs on spawned gloo CPU ranks (2, or 4 for the
(data, model) = (2, 2) mesh) and is held against the port's own unsharded
run, at the reference test's tolerance (1e-5 for the train steps, 1e-4
for the joint step, bit for bit for generation, the pool and
``run_jobs``); the train and joint steps are also held against the JAX
package's unsharded step from the same parameters (``convert``).

The ranks are spawned once per scenario group (a module fixture) and each
result is asserted in its own test.  The rank functions live here and
import no JAX (a spawned rank imports this module to find them); the JAX
package is imported inside the tests that compare with it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from samplernn_pase_tpu_torch import convert, graft_entry
from samplernn_pase_tpu_torch.config import PASEConfig, SampleRNNConfig
from samplernn_pase_tpu_torch.config import TrainConfig
from samplernn_pase_tpu_torch.data import dataset as tds
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.ops.kernels.noise import int_key
from samplernn_pase_tpu_torch.parallel import dryrun
from samplernn_pase_tpu_torch.parallel import mesh as pm
from samplernn_pase_tpu_torch.parallel.launch import run_ranks
from samplernn_pase_tpu_torch.serve import StreamPool, run_jobs
from samplernn_pase_tpu_torch.train import trainer as tr

from torch_threads import one_thread  # noqa: F401 (a fixture)

BASE = dict(frame_sizes=(4, 2), dim=16, embed_dim=8, compute_dtype="float32")
COND = dict(BASE, cond_dim=6, cond_rate=8, n_speakers=4)
PASE = dict(sinc_filters=8, sinc_kernel=33, blocks=((8, 5, 4), (12, 5, 4)),
            emb_dim=10, compute_dtype="float32")
JOINT = dict(BASE, cond_dim=10, cond_rate=16)
B = 8
LR = 1e-2       # the reference tests' rate: sharded against unsharded
JAX_LR = 1e-3   # against the JAX package, as tests/test_torch_train.py:
                # Adam's first step moves a weight by about the rate
                # whatever its gradient, so at 1e-2 a near-zero gradient's
                # float32 rounding shows above 1e-5


# ------------------------------------------------------------ inputs

def _jax_params(seed, kw):
    """The JAX package's parameters for config ``kw`` as numpy trees."""
    import jax

    from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
    from samplernn_pase_tpu.models import samplernn as jsrnn
    return jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed),
                                            JCfg(**kw)))


def _step_case(seed, kw, *, lstm_state=False, clip=1.0):
    """A train-step scenario as the reference test builds it: params from
    PRNGKey(seed), a batch from default_rng(seed)."""
    cfg = SampleRNNConfig(**kw)
    rng = np.random.default_rng(seed)
    t = cfg.lookback * 4
    case = {"kw": kw, "params": _jax_params(seed, kw), "clip": clip,
            "inputs": rng.integers(0, 256, (B, cfg.lookback + t), np.int32),
            "resets": np.ones((B,), np.float32)}
    if cfg.cond_dim:
        case["cond"] = rng.normal(size=(B, t // cfg.cond_rate,
                                        cfg.cond_dim)).astype(np.float32)
        case["speakers"] = rng.integers(0, cfg.n_speakers, (B,),
                                        dtype=np.int32)
    if lstm_state:
        case["resets"] = np.zeros((B,), np.float32)   # carry the state
        case["state0"] = tuple(
            (rng.normal(size=(cfg.n_rnn, 2, B, cfg.dim)) * 0.1).astype(
                np.float32) for _ in range(cfg.n_tiers))
    return case


def _run_step(case, mesh, lr=LR):
    cfg = SampleRNNConfig(**case["kw"])
    return dryrun.train_step(
        cfg, convert.params_from_jax(case["params"]), case["inputs"],
        case["resets"], mesh=mesh, cond=case.get("cond"),
        speakers=case.get("speakers"), state0=case.get("state0"), lr=lr,
        clip=case["clip"])


def _joint_case():
    import jax

    from samplernn_pase_tpu.config import PASEConfig as JPase
    from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
    from samplernn_pase_tpu.train import joint as jjoint
    jp, jb = jax.device_get(jjoint.init_joint(
        jax.random.PRNGKey(7), JCfg(**JOINT), JPase(**PASE)))
    rng = np.random.default_rng(7)
    cfg = SampleRNNConfig(**JOINT)
    return {"params": jp, "bn": jb,
            "inputs": rng.integers(0, 256, (B, cfg.lookback + 64), np.int32),
            "resets": np.ones((B,), np.float32)}


def _run_joint(case, mesh):
    params, bn = convert.joint_from_jax(case["params"], case["bn"])
    return dryrun.joint_step(SampleRNNConfig(**JOINT), PASEConfig(**PASE),
                             params, bn, case["inputs"], case["resets"],
                             mesh=mesh, lr=LR)


def _ragged_corpus(n=16, seed=3, lo=300, hi=1100):
    """Ragged utterances (masked tails, resets inside a group)."""
    rng = np.random.default_rng(seed)
    utts = []
    for _ in range(n):
        x = 0.6 * np.sin(np.arange(int(rng.integers(lo, hi)))
                         * rng.uniform(0.05, 0.3))
        utts.append(tds._quantize_host(x.astype(np.float32), 256))
    return tds.WavCorpus(utts, val_frac=0.3)


class _Record(tr.Plugin):
    def __init__(self):
        self.rec = []

    def on_step(self, trainer, step, metrics):
        self.rec.append((step, metrics["nll_bits"], trainer.batch_idx))


def _host(tree):
    return convert.to_numpy(tree)


def _trainer_run(mesh, *, ckpt_dir=None, restore_from=None,
                 restore_step=None, epochs=1):
    """``Trainer`` over the ragged corpus at steps_per_call 3 (groups and
    single-step tails), B=8, seq_len 64; a checkpoint every 2 steps into
    ``ckpt_dir``; or resumed from ``restore_from`` and run to ``epochs``.
    Returns the steps, validate(), the parameters and whole hiddens."""
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager
    tcfg = TrainConfig(batch_size=B, seq_len=64, epochs=epochs,
                       steps_per_call=3, lr=LR, lr_schedule="cosine",
                       warmup_steps=2, decay_steps=50)
    rec = _Record()
    plugins = [rec]
    if ckpt_dir is not None:
        plugins.append(tr.CheckpointPlugin(
            CheckpointManager(ckpt_dir, max_to_keep=100), every_steps=2))
    t = tr.Trainer(SampleRNNConfig(**BASE), tcfg, _ragged_corpus(), plugins,
                   device="cpu", mesh=mesh)
    if restore_from is not None:
        assert t.restore(CheckpointManager(restore_from), restore_step)
    t.run(epochs)
    return {"rec": rec.rec, "val": t.validate(), "params": _host(t.params),
            "hiddens": _host(pm.gather_state(t.data_mesh, t.hiddens)),
            "step": t.global_step}


def _joint_trainer_run(mesh):
    from samplernn_pase_tpu_torch.train.joint import JointTrainer
    tcfg = TrainConfig(batch_size=B, seq_len=64, epochs=1, steps_per_call=2,
                       lr=LR)
    rec = _Record()
    t = JointTrainer(SampleRNNConfig(**JOINT), PASEConfig(**PASE), tcfg,
                     _ragged_corpus(n=12, seed=11, lo=300, hi=600), [rec],
                     device="cpu", mesh=mesh)
    t.run()
    return {"rec": rec.rec, "val": t.validate(), "params": _host(t.params),
            "bn": _host(t.bn_state)}


POOL = dict(BASE, cond_dim=6, cond_rate=4, n_speakers=3)


def _pool_run(mesh):
    """The reference test's pool lifecycle (staggered conditioned joins, a
    prompt join, a stop and slot reuse), plus a prompted join pinned to a
    lane of the second rank's block and an extension of its rows."""
    cfg = SampleRNNConfig(**POOL)
    params = samplernn.init_params(torch.Generator().manual_seed(2), cfg,
                                   "cpu")
    chunk = int(np.lcm(cfg.lookback, cfg.cond_rate)) * 2
    rng = np.random.default_rng(3)
    conds = [rng.normal(size=(10 + i, 6)).astype(np.float32)
             for i in range(5)]
    prompt = rng.integers(0, 256, (3 * cfg.lookback,), np.int64)
    pool = StreamPool(params, cfg, n_lanes=8, temperature=None, mesh=mesh,
                      device="cpu")
    a = pool.start(cond=conds[0], speaker=1)
    out = [pool.emit(chunk).numpy()]
    b = pool.start(cond=conds[1], speaker=0, seed_levels=prompt,
                   seed_cond=conds[2][:4])
    d = pool.start(cond=conds[4], speaker=2, seed_levels=prompt[:16],
                   lane=6)
    out.append(pool.emit(chunk).numpy())
    pool.stop(a)
    c = pool.start(cond=conds[3], speaker=2)   # reuses a's slot
    pool.extend_cond(d, conds[0][:5])
    out.append(pool.emit(chunk).numpy())
    return np.concatenate(out, axis=1), (a, b, c, d)


def _run_jobs_run(mesh):
    cfg = SampleRNNConfig(**dict(POOL, n_speakers=2))
    params = samplernn.init_params(torch.Generator().manual_seed(4), cfg,
                                   "cpu")
    rng = np.random.default_rng(7)
    jobs = [{"id": i, "cond": rng.normal(size=(2 + 2 * i, 6)).astype(
                 np.float32), "speaker": i % 2,
             "stream_key": int_key(50 + i)}
            for i in range(12)]                    # 12 jobs over 8 lanes
    for job in jobs[::3]:
        # noise keyed by the lane's global index and epoch
        del job["stream_key"]
    results, stats = run_jobs(params, cfg, jobs, n_lanes=8,
                              chunk=cfg.lookback, temperature=0.9, seed=0,
                              device="cpu", mesh=mesh)
    return results, stats["chunks"]


def _gen_runs(mesh):
    """Greedy generation, then conditioned with speakers, lanes over
    ``data``."""
    cfg = SampleRNNConfig(**BASE)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    ccfg = SampleRNNConfig(**COND)
    cparams = samplernn.init_params(torch.Generator().manual_seed(6), ccfg,
                                    "cpu")
    rng = np.random.default_rng(6)
    length = ccfg.lookback * 4
    cond = rng.normal(size=(B, length // ccfg.cond_rate,
                            ccfg.cond_dim)).astype(np.float32)
    spk = rng.integers(0, 4, (B,), dtype=np.int32)
    return (dryrun.generate_greedy(cfg, params, B, cfg.lookback * 2,
                                   mesh=mesh),
            dryrun.generate_greedy(ccfg, cparams, B, length, mesh=mesh,
                                   cond=cond, speakers=spk))


def _coords(mesh):
    return {a: (pm.axis_size(mesh, a), pm.axis_rank(mesh, a))
            for a in pm.AXES}


# ------------------------------------------------------------- ranks

def _dp_rank(rank, world, spec):
    mesh = pm.make_mesh()
    out = {"coords": _coords(mesh)}
    for name, case in spec["steps"].items():
        out[name] = _run_step(case, mesh)
        out[name + "@jax_lr"] = _run_step(case, mesh, JAX_LR)
    out["joint"] = _run_joint(spec["joint"], mesh)
    out["gen"], out["cond_gen"] = _gen_runs(mesh)
    out["pool"] = _pool_run(mesh)
    out["run_jobs"] = _run_jobs_run(mesh)
    out["trainer"] = _trainer_run(mesh, ckpt_dir=spec["mesh_ckpt"])
    out["resumed"] = _trainer_run(mesh, restore_from=spec["plain_ckpt"],
                                  restore_step=2, epochs=2)
    out["joint_trainer"] = _joint_trainer_run(mesh)
    return out


def _tp_rank(rank, world, spec):
    mesh = pm.make_mesh((2, 2), ("data", "model"))
    out = {"coords": _coords(mesh)}
    for name, case in spec["steps"].items():
        out[name] = _run_step(case, mesh)
        out[name + "@jax_lr"] = _run_step(case, mesh, JAX_LR)
    out["pool"] = _pool_run(mesh)
    return out


# name: (seed, config, carried LSTM state, clip)
DP_STEPS = {"dp": (0, BASE, False, 1.0), "dp_cond": (1, COND, False, 1.0),
            "dp_lstm": (5, dict(BASE, rnn_type="lstm", n_rnn=2), True, 1.0)}
TP_STEPS = {"tp": (2, BASE, False, 1.0), "tp_cond": (4, COND, False, 1.0),
            "tp_weight_norm": (8, dict(COND, weight_norm=True), False, 1.0),
            # a clip far under the gradient's norm, so that the norm (the
            # MLP shards' squares summed over 'model') sets the step
            "tp_clipped": (9, dict(COND, weight_norm=True), False, 1e-3)}


# one intra-op thread in this process (torch_threads.py); the spawned
# ranks take one each too
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def cases():
    steps = {name: _step_case(seed, kw, lstm_state=lstm, clip=clip)
             for name, (seed, kw, lstm, clip)
             in {**DP_STEPS, **TP_STEPS}.items()}
    return {"steps": steps, "joint": _joint_case()}


@pytest.fixture(scope="module")
def plain_ckpt(tmp_path_factory):
    """An unsharded run's checkpoints (every 2 steps), and the run."""
    d = tmp_path_factory.mktemp("plain_ckpt")
    return d, _trainer_run(None, ckpt_dir=d)


@pytest.fixture(scope="module")
def plain_two_epochs():
    """The uninterrupted unsharded run a resume must continue."""
    return _trainer_run(None, epochs=2)


@pytest.fixture(scope="module")
def mesh_ckpt(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_ckpt")


@pytest.fixture(scope="module")
def dp(cases, plain_ckpt, mesh_ckpt):
    """The 2-rank (data,) mesh's results, rank by rank."""
    spec = {"steps": {k: cases["steps"][k] for k in DP_STEPS},
            "joint": cases["joint"], "mesh_ckpt": mesh_ckpt,
            "plain_ckpt": plain_ckpt[0]}
    return run_ranks(_dp_rank, 2, (spec,), timeout=600)


@pytest.fixture(scope="module")
def tp(cases):
    """The 4-rank (data, model) = (2, 2) mesh's results."""
    spec = {"steps": {k: cases["steps"][k] for k in TP_STEPS}}
    return run_ranks(_tp_rank, 4, (spec,), timeout=600)


# -------------------------------------------------- reference helpers

def _jax_step(case):
    """The JAX package's unsharded train step at ``JAX_LR``: (nll,
    params)."""
    import jax
    import jax.numpy as jnp

    from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
    from samplernn_pase_tpu.models import samplernn as jsrnn
    from samplernn_pase_tpu.train.optim import make_optimizer
    from samplernn_pase_tpu.train.trainer import make_train_step
    jc = JCfg(**case["kw"])
    tx = make_optimizer(JAX_LR, case["clip"])
    p = jax.tree.map(jnp.asarray, case["params"])
    h = (jsrnn.initial_state(p, jc, B) if "state0" not in case
         else tuple(jnp.asarray(s) for s in case["state0"]))
    x = jnp.asarray(case["inputs"])
    extra = {k: jnp.asarray(case[k]) for k in ("cond", "speakers")
             if k in case}
    p2, _, _, nll = make_train_step(jc, tx)(
        p, tx.init(p), h, x, x[:, jc.lookback:], jnp.asarray(case["resets"]),
        **extra)
    return float(nll), jax.device_get(p2)


def _by_key(port, ref, tol, where="params"):
    """Leaf by leaf, matched by key (JAX flattens dicts in sorted order)."""
    if isinstance(port, dict):
        assert set(port) == set(ref), where
        for k in port:
            _by_key(port[k], ref[k], tol, f"{where}.{k}")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _by_key(a, b, tol, f"{where}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                                   atol=tol, rtol=tol, err_msg=where)


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        dryrun.assert_close(r[key], first, 0.0, key)
    return first


def _hold_step(results, cases, name):
    """The sharded step equals the port's unsharded step (NLL, params,
    hiddens) and the JAX package's (NLL, params), within 1e-5."""
    case = cases["steps"][name]
    nll_s, p_s, h_s = _same_on_every_rank(results, name)
    nll_u, p_u, h_u = _run_step(case, None)
    assert abs(nll_s - nll_u) < 1e-5, (nll_s, nll_u)
    dryrun.assert_close((p_s, h_s), (p_u, h_u), 1e-5, name)
    nll_s, p_s, _ = _same_on_every_rank(results, name + "@jax_lr")
    nll_j, p_j = _jax_step(case)
    assert abs(nll_s - nll_j) < 1e-5, (nll_s, nll_j)
    _by_key(p_s, p_j, 1e-5)


# ------------------------------------------------------------- tests

def test_gloo_ranks_form_meshes(dp, tp):
    """The counterpart of the reference's eight virtual devices: 2 and 4
    spawned gloo ranks form their meshes, each rank at its coordinate."""
    assert [r["coords"]["data"] for r in dp] == [(2, 0), (2, 1)]
    assert all(r["coords"]["model"] == (1, 0) for r in dp)
    assert [r["coords"]["data"] for r in tp] == [(2, 0), (2, 0), (2, 1),
                                                 (2, 1)]
    assert [r["coords"]["model"] for r in tp] == [(2, 0), (2, 1), (2, 0),
                                                  (2, 1)]


def test_dp_train_step_matches_single_device(dp, cases):
    """Gradient math identical sharded and unsharded."""
    _hold_step(dp, cases, "dp")


def test_generation_batch_sharded(dp):
    """Greedy decode with lanes split over 'data' equals the unsharded
    decode (lanes are independent: no collective changes results)."""
    got = _same_on_every_rank(dp, "gen")
    want, _ = _gen_runs(None)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_entrypoint(n, capsys):
    line = graft_entry.dryrun_multichip(n)
    assert line.startswith(f"dryrun_multichip({n}): ") and line.endswith(
        "OK")
    assert ("'model': 2" if n == 4 else "'model': 1") in line
    assert line in capsys.readouterr().out


def test_entry_compiles():
    fn, args = graft_entry.entry(device="cpu")
    nll, state = fn(*args)
    assert np.isfinite(float(nll)) and len(state) == 2


def test_trainer_with_mesh_runs(dp, plain_ckpt):
    """Trainer(mesh=...) end to end on 2 ranks over a ragged corpus
    (masked tails weigh by the global count), at steps_per_call 3:
    the same steps, NLLs, validate(), parameters and hiddens as the
    unsharded run, within 1e-5."""
    got = _same_on_every_rank(dp, "trainer")
    want = plain_ckpt[1]
    assert got["step"] == want["step"] > 0
    assert [(s, i) for s, _, i in got["rec"]] == [(s, i) for s, _, i in
                                                   want["rec"]]
    np.testing.assert_allclose([n for _, n, _ in got["rec"]],
                               [n for _, n, _ in want["rec"]], atol=1e-5)
    assert np.isfinite(got["val"]) and abs(got["val"] - want["val"]) < 1e-5
    dryrun.assert_close((got["params"], got["hiddens"]),
                        (want["params"], want["hiddens"]), 1e-5, "trainer")


def test_2d_mesh_tp_train_step_matches_single_device(tp, cases):
    """The (data, model) mesh with the sample MLP split over 'model'
    gives the unsharded step's params, hiddens and NLL."""
    _hold_step(tp, cases, "tp")


def test_dp_conditioned_train_step_matches_single_device(dp, cases):
    _hold_step(dp, cases, "dp_cond")


def test_2d_mesh_conditioned_speakers_matches_single_device(tp, cases):
    _hold_step(tp, cases, "tp_cond")


def test_2d_mesh_weight_norm_train_step_matches_single_device(tp, cases):
    """Weight norm under the 'model' split: the row-sharded w_out's norm
    sums its squares over 'model'; the column shards resolve locally."""
    _hold_step(tp, cases, "tp_weight_norm")


def test_2d_mesh_clipped_train_step_matches_single_device(tp, cases):
    """Global-norm clipping under the 'model' split: a sharded leaf's
    squares summed over its shards, a replicated leaf's counted once."""
    _hold_step(tp, cases, "tp_clipped")


def test_dp_lstm_train_step_matches_single_device(dp, cases):
    """LSTM state [n_rnn, 2, B, H] split on axis -2, carried (no reset)."""
    _hold_step(dp, cases, "dp_lstm")


def test_conditioned_generation_sharded_matches_unsharded(dp):
    got = _same_on_every_rank(dp, "cond_gen")
    _, want = _gen_runs(None)
    np.testing.assert_array_equal(got, want)


def test_dp_joint_train_step_matches_single_device(dp, cases):
    """The joint step under the mesh: the encoder's gradients summed over
    'data' with the SampleRNN half's, its BatchNorm on the whole batch's
    statistics; against the port's unsharded step and the JAX package's,
    within 1e-4."""
    import jax
    import jax.numpy as jnp

    from samplernn_pase_tpu.config import PASEConfig as JPase
    from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
    from samplernn_pase_tpu.models import samplernn as jsrnn
    from samplernn_pase_tpu.train import joint as jjoint
    from samplernn_pase_tpu.train.optim import make_optimizer

    case = cases["joint"]
    nll_s, p_s, bn_s, h_s = _same_on_every_rank(dp, "joint")
    nll_u, p_u, bn_u, h_u = _run_joint(case, None)
    assert abs(nll_s - nll_u) < 1e-5, (nll_s, nll_u)
    dryrun.assert_close((p_s, bn_s, h_s), (p_u, bn_u, h_u), 1e-4, "joint")
    jc, jpc = JCfg(**JOINT), JPase(**PASE)
    tx = make_optimizer(LR, 1.0)
    p = jax.tree.map(jnp.asarray, case["params"])
    x = jnp.asarray(case["inputs"])
    p2, _, bn2, _, nll = jjoint.make_joint_train_step(jc, jpc, tx)(
        p, tx.init(p), jax.tree.map(jnp.asarray, case["bn"]),
        jsrnn.initial_state(p["srnn"], jc, B), x, x[:, jc.lookback:],
        jnp.asarray(case["resets"]))
    assert abs(nll_s - float(nll)) < 1e-4
    _by_key(p_s, jax.device_get(p2), 1e-4)
    _by_key(bn_s, jax.device_get(bn2), 1e-4, "bn")


def test_joint_trainer_with_mesh_runs(dp):
    """JointTrainer(mesh=...) end to end: the unsharded run's steps and
    NLLs (1e-4), validate(), and BatchNorm state equal on both ranks."""
    got = _same_on_every_rank(dp, "joint_trainer")
    want = _joint_trainer_run(None)
    assert len(got["rec"]) == len(want["rec"]) > 0
    np.testing.assert_allclose([n for _, n, _ in got["rec"]],
                               [n for _, n, _ in want["rec"]], atol=1e-4)
    assert np.isfinite(got["val"]) and abs(got["val"] - want["val"]) < 1e-4
    dryrun.assert_close((got["params"], got["bn"]),
                        (want["params"], want["bn"]), 1e-4, "joint trainer")


def test_stream_pool_sharded_matches_unsharded(dp):
    """The pool with lanes over 'data' emits bit for bit what the
    unsharded pool emits through its lifecycle, and returns the same
    lanes."""
    got, lanes = _same_on_every_rank(dp, "pool")
    want, lanes_u = _pool_run(None)
    assert lanes == lanes_u and lanes[2] == lanes[0]
    np.testing.assert_array_equal(got, want)


def test_stream_pool_on_2d_mesh_matches_unsharded(tp):
    """A (data, model) mesh: lanes over 'data' only, the MLP whole on
    every rank; the same audio."""
    got, lanes = _same_on_every_rank(tp, "pool")
    want, lanes_u = _pool_run(None)
    assert lanes == lanes_u
    np.testing.assert_array_equal(got, want)


def test_run_jobs_sharded_matches_unsharded(dp):
    """run_jobs over the mesh (12 sampled, pinned-key jobs on 8 lanes,
    churn across chunk boundaries): bit for bit the unsharded run."""
    got, chunks = dp[0]["run_jobs"]
    want, chunks_u = _run_jobs_run(None)
    assert chunks == chunks_u and set(got) == set(want) == set(range(12))
    for r in dp[1:]:
        assert set(r["run_jobs"][0]) == set(got)
        for i in got:
            np.testing.assert_array_equal(r["run_jobs"][0][i], got[i])
    for i in range(12):
        np.testing.assert_array_equal(got[i], want[i])


def test_mesh_checkpoint_resumes_unsharded(dp, mesh_ckpt, plain_two_epochs):
    """A 2-rank run's mid-epoch checkpoint (step 2, hiddens gathered,
    written by the chief) restored into an unsharded Trainer continues as
    the uninterrupted unsharded run, within 1e-5."""
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager
    assert 2 in CheckpointManager(mesh_ckpt).all_steps()
    got = _trainer_run(None, restore_from=mesh_ckpt, restore_step=2,
                       epochs=2)
    _hold_resumed(got, plain_two_epochs)


def test_unsharded_checkpoint_resumes_on_mesh(dp, plain_two_epochs):
    """The reverse: the unsharded run's step-2 checkpoint restored on 2
    ranks (each takes its block of the hiddens) continues as the
    uninterrupted unsharded run, within 1e-5."""
    _hold_resumed(_same_on_every_rank(dp, "resumed"), plain_two_epochs)


def _hold_resumed(got, want):
    tail = {s: n for s, n, _ in want["rec"]}
    assert got["rec"] and got["rec"][0][0] == 3
    for s, n, _ in got["rec"]:
        assert abs(n - tail[s]) < 1e-5, (s, n, tail[s])
    assert got["step"] == want["step"]
    dryrun.assert_close((got["params"], got["hiddens"]),
                        (want["params"], want["hiddens"]), 1e-5, "resumed")


def test_pool_and_trainer_refuse_an_uneven_split():
    """n_lanes and batch_size must divide over 'data' (the reference's
    check), raised before any rank work; checked on a stand-in mesh."""
    class TwoRanks:
        mesh_dim_names = ("data",)
        ndim = 1

        def size(self, i):
            return 2

    cfg = SampleRNNConfig(**BASE)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    with pytest.raises(ValueError, match="must divide over the mesh data"):
        StreamPool(params, cfg, n_lanes=3, mesh=TwoRanks(), device="cpu")
    with pytest.raises(ValueError, match="must divide over the mesh data"):
        tr.Trainer(cfg, TrainConfig(batch_size=3, seq_len=64),
                   tds.synthetic_corpus(n_utts=2, length=512), params=params,
                   device="cpu", mesh=TwoRanks())


def test_shard_rules_match_the_reference():
    """shard_params' placement: mlp.w_in and w_h by columns (with their
    weight-norm gains), w_out by rows (its gain replicated), the rest
    replicated, in any tree that carries the paths (an Adam state)."""
    d = pm._shard_dim
    assert d(("mlp", "w_in")) == d(("mlp", "w_h")) == -1
    assert d(("mu", "mlp", "w_in", "v")) == d(("mlp", "w_h", "g")) == -1
    assert d(("srnn", "mlp", "w_out")) == d(("mlp", "w_out", "v")) == 0
    for path in (("mlp", "w_out", "g"), ("mlp", "b_in"), ("mlp", "embed"),
                 ("tiers", 0, "w_ih"), ("pase", "blocks", 0, "w")):
        assert d(path) is None, path
    assert dataclasses.asdict(pm.state_sharding(None, 4))["dim"] == 2
    assert pm.staged_sharding(None, 3).dim == 1
    assert pm.batch_sharding(None).dim == 0 and pm.replicated(None).dim is None

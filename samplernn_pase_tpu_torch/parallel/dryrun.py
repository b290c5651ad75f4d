"""The mesh paths run sharded and whole, side by side: what
``graft_entry.dryrun_multichip`` checks on every rank (the reference's
``__graft_entry__.dryrun_multichip``), in helpers the tests share.

Each helper takes whole host arrays and whole parameters, places this
rank's part on ``device`` (its shards under ``mesh``, everything without
one), runs the path and returns the whole result on every rank, so a
sharded run and an unsharded run compare directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from samplernn_pase_tpu_torch.parallel import mesh as pm
from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map


def _on(tree, dev):
    return tree_map(lambda t: t.detach().clone().to(dev)
                    if isinstance(t, torch.Tensor) else t, tree)


def _host_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def _batch(mesh, dev, *arrays):
    """This rank's block (axis 0) of each host array, on ``dev``."""
    return [None if a is None else torch.as_tensor(a).to(dev)
            for a in pm.shard_batch(mesh, [np.asarray(a) if a is not None
                                           else None for a in arrays])]


def train_step(cfg, params, inputs, resets, *, mesh=None, cond=None,
               speakers=None, state0=None, lr: float = 1e-3,
               clip: float = 1.0, device="cpu"):
    """One TBPTT train step (``make_train_step(cfg, make_optimizer(lr,
    clip), mesh)``) from whole host arrays: inputs [B, lookback + T],
    resets [B], cond [B, F, D], speakers [B], state0 (per tier, whole)
    or the initial state.  Returns (nll, params, hiddens) whole, as
    numpy, on every rank."""
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import make_train_step

    dev = torch.device(device)
    b = np.shape(inputs)[0]
    tx = make_optimizer(lr, clip)
    p = _on(params, dev)
    h = (samplernn.initial_state(p, cfg, b) if state0 is None
         else tuple(torch.as_tensor(np.asarray(s)).to(dev) for s in state0))
    p = pm.shard_params(p, mesh)
    opt = tx.init(p)
    h = pm.shard_state(mesh, h)
    x, r, c, s = _batch(mesh, dev, inputs, resets, cond, speakers)
    step = make_train_step(cfg, tx, mesh)
    p2, _, h2, nll = step(p, opt, h, x, x[:, cfg.lookback:], r, cond=c,
                          speakers=s)
    return (float(nll), _host_tree(pm.unshard_params(p2, mesh)),
            _host_tree(pm.gather_state(mesh, h2)))


def joint_step(mcfg, pcfg, params, bn_state, inputs, resets, *, mesh=None,
               lr: float = 1e-2, clip: float = 1.0, device="cpu"):
    """One joint PASE + SampleRNN step (``make_joint_train_step``) from
    whole host arrays.  Returns (nll, params, bn_state, hiddens) whole,
    as numpy, on every rank."""
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.train import joint
    from samplernn_pase_tpu_torch.train.optim import make_optimizer

    dev = torch.device(device)
    b = np.shape(inputs)[0]
    tx = make_optimizer(lr, clip)
    p, bs = _on(params, dev), _on(bn_state, dev)
    opt = tx.init(p)
    h = pm.shard_state(mesh, samplernn.initial_state(p["srnn"], mcfg, b))
    x, r = _batch(mesh, dev, inputs, resets)
    step = joint.make_joint_train_step(mcfg, pcfg, tx, mesh=mesh)
    p2, _, bs2, h2, nll = step(p, opt, bs, h, x, x[:, mcfg.lookback:], r)
    return (float(nll), _host_tree(p2), _host_tree(bs2),
            _host_tree(pm.gather_state(mesh, h2)))


def generate_greedy(cfg, params, n: int, length: int, *, mesh=None,
                    cond=None, speakers=None, use_kernels=None,
                    device="cpu") -> np.ndarray:
    """Greedy levels [n, length]: each rank decodes its block of the
    lanes (no collective: lanes are independent) and the blocks are
    gathered."""
    from samplernn_pase_tpu_torch import generate as gen

    dev = torch.device(device)
    nl = n // pm.axis_size(mesh, "data")
    c, s = _batch(mesh, dev, cond, speakers)
    lv = gen.generate_levels(_on(params, dev), cfg, nl, length, None,
                             cond=c, speakers=s, use_kernels=use_kernels,
                             device=dev)
    return pm.gather_batch(mesh, lv).cpu().numpy()


def assert_close(a, b, tol: float, what: str):
    """Every leaf within ``tol`` absolute plus ``tol`` relative."""
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=tol, err_msg=f"{what}: leaf {i}")


def _flagship_tiny():
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    return SampleRNNConfig(frame_sizes=(4, 2), dim=32, embed_dim=16,
                           compute_dtype="float32")


def dryrun_rank(rank: int, world: int, device) -> str:
    """``dryrun_multichip``'s checks on one rank (see there); returns the
    summary line."""
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels.noise import int_key
    from samplernn_pase_tpu_torch.serve import StreamPool

    dev = torch.device(device or "cpu")
    shape = (world // 2, 2) if world % 2 == 0 and world >= 4 else (world, 1)
    mesh = pm.make_mesh(shape, ("data", "model"))
    cfg = _flagship_tiny()
    b, t = shape[0] * 2, cfg.lookback * 4      # 2 lanes per data shard
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    rng = np.random.default_rng(0)
    inputs = rng.integers(0, cfg.q_levels, (b, cfg.lookback + t), np.int32)
    resets = np.ones((b,), np.float32)
    kw = dict(device=dev)

    # the dp x tp train step equals the unsharded step (params, state, NLL)
    nll_s, p_s, h_s = train_step(cfg, params, inputs, resets, mesh=mesh,
                                 **kw)
    nll_u, p_u, h_u = train_step(cfg, params, inputs, resets, **kw)
    if not np.isfinite(nll_s) or abs(nll_s - nll_u) >= 1e-5:
        raise AssertionError(f"train step NLL {nll_s} vs {nll_u}")
    assert_close((p_s, h_s), (p_u, h_u), 1e-5, "train step")

    # greedy generation with lanes split over 'data'
    t_gen = cfg.lookback * 2
    got = generate_greedy(cfg, params, b, t_gen, mesh=mesh, **kw)
    want = generate_greedy(cfg, params, b, t_gen, **kw)
    np.testing.assert_array_equal(got, want)

    # a conditioned + speaker LSTM train step on the same mesh (LSTM state
    # [n_rnn, 2, B, H] split on axis -2, the MLP over 'model'), and
    # conditioned greedy generation
    ccfg = dataclasses.replace(cfg, rnn_type="lstm", cond_dim=12,
                               cond_rate=8, n_speakers=4)
    cparams = samplernn.init_params(torch.Generator().manual_seed(1), ccfg,
                                    "cpu")
    cond = rng.normal(size=(b, t // ccfg.cond_rate, 12)).astype(np.float32)
    spk = rng.integers(0, 4, (b,)).astype(np.int32)
    ck = dict(cond=cond, speakers=spk, **kw)
    cnll_s, cp_s, ch_s = train_step(ccfg, cparams, inputs, resets, mesh=mesh,
                                    **ck)
    cnll_u, cp_u, ch_u = train_step(ccfg, cparams, inputs, resets, **ck)
    if abs(cnll_s - cnll_u) >= 1e-5:
        raise AssertionError(f"conditioned train step NLL {cnll_s} vs "
                             f"{cnll_u}")
    assert_close((cp_s, ch_s), (cp_u, ch_u), 1e-5, "conditioned step")
    gcond = rng.normal(size=(b, t_gen // ccfg.cond_rate, 12)).astype(
        np.float32)
    gk = dict(cond=gcond, speakers=spk, **kw)
    np.testing.assert_array_equal(
        generate_greedy(ccfg, cparams, b, t_gen, mesh=mesh, **gk),
        generate_greedy(ccfg, cparams, b, t_gen, **gk))

    # the serving pool's lifecycle with lanes over 'data': staggered
    # conditioned joins, a stop and slot reuse, then sampled lanes (keys
    # from the global lane index, one pinned) at an unaligned chunk
    pcfg = dataclasses.replace(cfg, cond_dim=12, cond_rate=12)
    pparams = samplernn.init_params(torch.Generator().manual_seed(3), pcfg,
                                    "cpu")
    pchunk = int(np.lcm(pcfg.lookback, pcfg.cond_rate)) * 2
    pchunk2 = pcfg.lookback
    assert pchunk2 % pcfg.cond_rate != 0
    pconds = [rng.normal(size=(12, 12)).astype(np.float32)
              for _ in range(3)]

    def run_pool(m):
        pool = StreamPool(pparams, pcfg, n_lanes=b, temperature=None,
                          mesh=m, **kw)
        a0 = pool.start(cond=pconds[0])
        out = [pool.emit(pchunk).cpu().numpy()]
        pool.start(cond=pconds[1])
        out.append(pool.emit(pchunk2).cpu().numpy())
        pool.stop(a0)
        pool.start(cond=pconds[2])       # slot reuse
        out.append(pool.emit(pchunk).cpu().numpy())
        spool = StreamPool(pparams, pcfg, n_lanes=b, temperature=0.9,
                           seed=6, mesh=m, **kw)
        spool.start(cond=pconds[0])
        spool.start(cond=pconds[1], stream_key=int_key(17))
        spool.start(cond=pconds[2], lane=b - 1)   # the last rank's lane
        out.append(spool.emit(pchunk2).cpu().numpy())
        return np.concatenate(out, axis=1)

    pool_mesh = pm.make_mesh((world,), ("data",))
    np.testing.assert_array_equal(run_pool(pool_mesh), run_pool(None))
    return (f"dryrun_multichip({world}): mesh={{'data': {shape[0]}, "
            f"'model': {shape[1]}}} nll={nll_s:.3f} bits, sharded == "
            "unsharded (train + generate + conditioned/speaker LSTM train + "
            "conditioned generate + serving-pool lifecycle incl. sampled "
            "per-lane noise at unaligned chunks) — OK")

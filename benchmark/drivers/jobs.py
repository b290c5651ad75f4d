"""Offline TTS batch synthesis through ``serve.run_jobs``.

A manifest holds ``jobs`` conditioned jobs: the length table's entries,
each with conditioning rows drawn from the seed, in an order drawn anew for
every manifest, each job with a noise key of its own (``stream_key``).
``run_jobs`` drains it through one pool of ``lanes`` lanes in
``chunk``-sample chunks at ``temperature``, keeping no audio
(``retain_results=False``) and handing each job's levels to an ``on_done``
that decodes them to a waveform on the card (K7,
``generate.decode_waveform``) and copies it to pinned host memory, both on
a stream of their own, so that they run beside the pool's next chunk and
not behind it (``Waves``).  Manifests run back to back until the window
has lasted ``--seconds``; a job counts once its waveform is on the host.

Checked: ``check_requests`` jobs drawn from the seed among those of the
window's manifests, the longest among them: the levels their waveforms
encode are replayed through the reference with their rows and keys
(``token_gap``), and each sample's distance from its level's mu-law value
(``wave_err``).
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from benchmark import generator, harness
from benchmark.drivers import stream as sdrv
from benchmark.reference import check as rcheck
from benchmark.weights import make_params


class Waves:
    """Finished jobs' levels decoded to waveforms on the card, each decode
    and its copy to the host queued on a side stream; a job is done once
    its copy has landed (``reap``)."""

    def __init__(self, run):
        self.cfg, self.device = run.cfg, run.device
        self.stream = (torch.cuda.Stream(run.device)
                       if run.device.type == "cuda" else None)
        self.pending: list = []           # (id, host copy, device tensors)
        self.done: dict = {}              # id -> samples on the host
        self.kept: dict = {}              # id -> waveform of a checked job
        self.keep: set = set()

    def add(self, jid, levels):
        from samplernn_pase_tpu_torch import generate as gen
        from samplernn_pase_tpu_torch import serve

        side = (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())
        with side:
            lv = torch.from_numpy(np.ascontiguousarray(levels, np.int32))
            lv = lv.to(self.device, non_blocking=True)[None]
            wave = gen.decode_waveform(lv, self.cfg)
            copy = serve.host_copy(wave)
        self.pending.append((jid, copy, (lv, wave)))
        self.reap(wait=False)

    def reap(self, wait: bool):
        from samplernn_pase_tpu_torch import serve

        still = []
        for jid, copy, refs in self.pending:
            if not wait and copy[1] is not None and not copy[1].query():
                still.append((jid, copy, refs))
                continue
            wave = serve.host_wait(copy)[0]
            self.done[jid] = wave.shape[0]
            if jid in self.keep:
                self.kept[jid] = wave.copy()
        self.pending = still


def manifest(reqs, order, keys, first_id: int) -> list:
    return [{"id": first_id + j, "cond": reqs["cond"][i],
             "stream_key": keys[j]} for j, i in enumerate(order)]


def setup(run):
    from samplernn_pase_tpu_torch import serve

    tr = run.traffic
    params = make_params(run.model, run.seed, run.device)
    reqs = sdrv.make_requests(run, tr["jobs"], 6)
    rng = generator.rng_for(run.seed, 7)
    # warm-up: short jobs through the same entry at the same lanes
    order = rng.permutation(tr["jobs"])[:tr["warm_jobs"]]
    keys = generator.lane_keys(len(order), rng)
    warm = [{"id": j, "cond": reqs["cond"][i][:tr["warm_rows"]],
             "stream_key": keys[j]} for j, i in enumerate(order)]
    waves = Waves(run)
    serve.run_jobs(params, run.cfg, warm, n_lanes=tr["lanes"],
                   chunk=tr["chunk"], temperature=tr["temperature"],
                   seed=run.seed, max_cond_frames=tr["max_cond_frames"],
                   on_done=waves.add, retain_results=False,
                   device=run.device)
    waves.reap(wait=True)
    run.sync()
    return {"params": params, "reqs": reqs, "rng": rng}


def window(run, state):
    from samplernn_pase_tpu_torch import serve
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

    tr = run.traffic
    reqs, rng = state["reqs"], state["rng"]
    waves = Waves(run)
    jobs: dict = {}                   # id -> (request, key)
    stats = {"generated": 0, "dispatched": 0, "chunks": 0}

    run.start_window()
    kdec.reset_launches()
    m = 0
    while True:
        run.tick()
        order = rng.permutation(tr["jobs"])
        keys = generator.lane_keys(tr["jobs"], rng)
        first = m * tr["jobs"]
        jobs.update({first + j: (i, keys[j]) for j, i in enumerate(order)})
        longest = first + int(np.argmax(reqs["samples"][order]))
        waves.keep |= {longest, *(first + rng.choice(
            tr["jobs"], tr["check_requests"], replace=False))}
        with run.span("run_jobs"):
            _, st = serve.run_jobs(
                state["params"], run.cfg, manifest(reqs, order, keys, first),
                n_lanes=tr["lanes"], chunk=tr["chunk"],
                temperature=tr["temperature"], seed=run.seed,
                max_cond_frames=tr["max_cond_frames"], on_done=waves.add,
                retain_results=False, device=run.device)
        with run.span("waveform"):
            waves.reap(wait=True)
        for k in stats:
            stats[k] += st[k]
        m += 1
        if run.elapsed() >= run.seconds:
            break
    run.end_window()
    run.attempted = m * tr["jobs"]
    run.failed = run.attempted - len(waves.done)
    samples = int(sum(waves.done.values()))
    run.e2e["gen_samples_per_s"] = samples / run.window_s
    run.counters.update(
        samples=samples, computed_samples=stats["dispatched"],
        requested=stats["generated"], lanes=tr["lanes"],
        top_frames=stats["chunks"] * (tr["chunk"] // run.cfg.lookback),
        launches=sum(kdec.LAUNCHES[k] for k in (
            "frame_decode", "gemm_bias", "gru_gates", "lstm_gates")))
    state.update(jobs=jobs, kept=waves.kept)


def check(run, state):
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    reqs, jobs = state["reqs"], state["jobs"]
    ids = sdrv.pick(run, sorted(state["kept"]),
                    lambda j: reqs["samples"][jobs[j][0]])
    items, errs, control_errs = [], [], []
    for j in ids:
        wave = torch.as_tensor(state["kept"][j]).to(run.device)[None]
        levels, err = rcheck.waveform_error(wave, run.cfg.q_levels)
        errs.append(err)
        if run.control:
            control_errs.append(rcheck.control_waveform_error(
                levels, run.cfg.q_levels))
        items.append((levels[0].cpu().numpy(), reqs["cond"][jobs[j][0]],
                      jobs[j][1]))
    out = sdrv.replay(run, state["params"], items)
    program = {"token_gap": out["gap"], "wave_err": max(errs)}
    run.readings = dict(program, tokens=out["tokens"])
    control = None
    if "control_gap" in out:
        control = {"token_gap": out["control_gap"],
                   "wave_err": max(control_errs)}
        run.readings.update({f"control_{k}": v for k, v in control.items()})
    return harness.compared(run, program, control)

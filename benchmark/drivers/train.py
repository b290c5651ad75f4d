"""Truncated-BPTT training through the port's ``Trainer.run``.

Set-up writes a corpus of ``clips`` clips of ``clip_samples`` samples each
as 16-bit wav files into ``$TMPDIR`` (mixtures of harmonics with noise,
drawn from the seed on the device, stored at the centres of their mu-law
levels), loads it with ``WavCorpus.from_folder`` (no held-out split) and
builds one ``Trainer`` (batch ``batch``, ``seq_len``, Adam at ``lr``, clip
``grad_clip`` by global norm, ``steps_per_call`` steps a group, the logger
plugin only, with an in-memory writer; no checkpoints, no validation).
That trainer takes its first group of ``steps_per_call`` steps through the
call the window makes (``_run_group`` on as many batches of its own feed:
the staged [K, B, ...] batches and the multi-step call), which also warms
the window's shapes; its NLLs and its state after the group are kept for
the check.  Then the window runs ``Trainer.run`` on the same trainer,
epoch after epoch, and closes at the end of the first group that finishes
after ``--seconds``.  A step counts once its NLL has been read on the host.

Checked: the reference re-derives the first group's batches from the wav
files and follows its steps from the same weights.  Compared: the NLL of
each of the group's first ``loss_steps`` steps (``loss_gap``, bits, the
worst step) and the change of the parameters over the whole group
(``change_gap``, by the worst leaf).  Read beside them and not compared:
every step's NLL gap and Adam's first moment after the group
(``moment_gap``, by the worst leaf), which the later steps' rounding moves
too far from seed to seed to hold (``PERF.md``).  The group's call shows
only its end state, so the first gradient alone cannot be read from it.
The control, in the program's place with ``run.control``, is the
reference in the precision ``control`` names (float8 for the real cell);
float8, int8 and half the batch are all read beside it.
"""

from __future__ import annotations

import shutil
import tempfile
import wave
from pathlib import Path

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import mulaw
from benchmark.reference import train as rtrain
from benchmark.weights import clone, leaves, make_params

CORPUS = "samplernn_benchmark_corpus"


class StopWindow(Exception):
    """Raised by the window's plugin at the end of the group that closes
    the window."""


class Lines:
    """The logger's writer, keeping its lines in memory."""

    def __init__(self):
        self.steps = []

    def write(self, **kv):
        if "nll_bits" in kv:
            self.steps.append(kv["nll_bits"])


def corpus_dir() -> Path:
    return Path(tempfile.gettempdir()) / CORPUS


def write_corpus(run, path: Path) -> None:
    """The clips as 16-bit mono wav files, their samples the mu-law values
    of levels drawn from the seed."""
    tr = run.traffic
    n, length = tr["clips"], tr["clip_samples"]
    gen = torch.Generator(device=run.device).manual_seed(run.seed ^ 0xC0FFEE)
    dev = run.device
    t = torch.arange(length, device=dev, dtype=torch.float32) / tr[
        "sample_rate"]
    f0 = 80.0 + 320.0 * torch.rand((n, 1), generator=gen, device=dev)
    x = torch.zeros((n, length), device=dev)
    for k in range(1, 5):
        amp = 0.1 + 0.4 * torch.rand((n, 1), generator=gen, device=dev)
        ph = 6.2831853 * torch.rand((n, 1), generator=gen, device=dev)
        x += amp * torch.sin(6.2831853 * f0 * k * t + ph)
    x = 0.8 * x / x.abs().amax(dim=1, keepdim=True)
    x += 0.02 * torch.randn((n, length), generator=gen, device=dev)
    q = run.cfg.q_levels
    centre = mulaw.decode(mulaw.encode(x, q), q)
    pcm = torch.clamp(torch.round(centre * 32768.0), -32768, 32767).to(
        torch.int16).cpu().numpy()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    for i in range(n):
        with wave.open(str(path / f"clip_{i:05d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(tr["sample_rate"])
            w.writeframes(pcm[i].tobytes())


def setup(run):
    from samplernn_pase_tpu_torch.config import TrainConfig
    from samplernn_pase_tpu_torch.data.dataset import WavCorpus
    from samplernn_pase_tpu_torch.train.trainer import (
        LoggerPlugin, Plugin, Trainer)

    tr = run.traffic
    path = corpus_dir()
    write_corpus(run, path)
    corpus = WavCorpus.from_folder(path, q_levels=run.cfg.q_levels,
                                   val_frac=0.0)
    params = make_params(run.model, run.seed, run.device)
    p0 = clone(params)
    lines = Lines()

    class Window(Plugin):
        """Ends the window at the end of a group once ``--seconds`` have
        passed."""

        def on_step(self, trainer, step, metrics):
            if run.window_t0 is None:
                return
            run.tick()
            if (step + 1 == trainer.resume_next_step
                    and run.elapsed() >= run.seconds):
                raise StopWindow

    tcfg = TrainConfig(batch_size=tr["batch"], seq_len=tr["seq_len"],
                       lr=tr["lr"], grad_clip=tr["grad_clip"],
                       steps_per_call=tr["steps_per_call"], shuffle=False,
                       epochs=1 << 30)
    trainer = Trainer(run.cfg, tcfg, corpus,
                      plugins=[LoggerPlugin(lines, every=1), Window()],
                      params=params, device=run.device)
    spc = tr["batch"] * tr["seq_len"]
    feed = iter(trainer._batcher("train"))
    trainer._run_group([(i, next(feed))
                        for i in range(tr["steps_per_call"])], spc)
    trainer._flush_pending()
    kept = {"nll": list(lines.steps),
            "mu": [t.detach().clone()
                   for _, t in leaves(trainer.opt_state["mu"])],
            "params": [t.detach().clone() for _, t in leaves(trainer.params)]}
    run.sync()
    return {"trainer": trainer, "lines": lines, "p0": p0, "kept": kept,
            "corpus": path}


def window(run, state):
    trainer, lines = state["trainer"], state["lines"]
    tr = run.traffic
    n0 = len(lines.steps)
    host0 = dict(trainer.host_s)
    run.start_window()
    try:
        with run.span("trainer.run"):
            trainer.run()
    except StopWindow:
        pass
    run.end_window()
    steps = len(lines.steps) - n0
    run.attempted = steps
    samples = steps * tr["batch"] * tr["seq_len"]
    run.e2e["train_samples_per_s"] = samples / run.window_s
    run.counters.update(
        steps=steps, train_samples=samples, lanes=tr["batch"],
        host_s={k: trainer.host_s[k] - host0[k] for k in host0})


def batches(run, path: Path, n: int):
    """The first ``n`` batches of the feed, worked out from the wav files:
    clip i in lane i mod batch, in file order; each clip after ``lookback``
    silent levels, cut into ``seq_len`` windows with ``lookback`` levels of
    context; a lane resets on its clip's first window."""
    tr = run.traffic
    q, lb, b, t = (run.cfg.q_levels, run.cfg.lookback, tr["batch"],
                   tr["seq_len"])
    files = sorted(path.glob("*.wav"))[:b]
    streams = []
    for f in files:
        with wave.open(str(f), "rb") as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        x = torch.as_tensor(pcm.astype(np.float32) / 32768.0)
        streams.append(torch.cat([torch.full((lb,), q // 2,
                                             dtype=torch.int64),
                                  mulaw.encode(x, q)]))
    out = []
    for k in range(n):
        inputs = torch.stack([s[k * t: k * t + lb + t] for s in streams])
        out.append((inputs.to(run.device),
                    torch.full((b,), k == 0, device=run.device)))
    return out


def readings(run, state, precision="float32", lanes=None) -> dict:
    """The numbers of the program's first group (``precision`` "program")
    or of the reference run in ``precision`` (on ``lanes`` of the batch, all
    by default) against the reference's float32 run: the worst NLL gap of
    the first ``loss_steps`` steps (and each step's), the worst leaf's
    first-moment gap and parameter-change gap."""
    tr = run.traffic
    p0 = state["p0"]
    bs = batches(run, state["corpus"], tr["steps_per_call"])
    want = state.get("want")
    if want is None:
        want = state["want"] = rtrain.run_steps(
            p0, run.model, bs, tr["lr"], tr["grad_clip"])
    if precision == "program":
        got = state["kept"]
    else:
        if lanes is not None:
            bs = [(x[lanes], r[lanes]) for x, r in bs]
        got = rtrain.run_steps(p0, run.model, bs, tr["lr"], tr["grad_clip"],
                               precision)
    start = rtrain.tree_leaves(p0)
    skip = rtrain.still_leaves(want["grad"])
    change = [a - s for a, s in zip(got["params"], start)]
    want_change = [a - s for a, s in zip(want["params"], start)]
    steps = [abs(a - b) for a, b in zip(got["nll"], want["nll"])]
    if len(steps) != len(want["nll"]):
        steps.append(float("inf"))        # a step whose NLL never came
    change_gaps = rtrain.leaf_gaps(change, want_change, skip)
    return {"loss_gap": max(steps[:tr["loss_steps"]]), "loss_gaps": steps,
            "moment_gap": rtrain.leaf_gap(got["mu"], want["mu"], skip),
            "change_gap": max(g for g in change_gaps if g is not None),
            "change_gaps": change_gaps, "clip_norms": want["norms"],
            "skipped": len(skip)}


def check(run, state):
    """The program's numbers beside their limits; with ``run.control`` the
    control's (the reference in the traffic's ``control`` precision in the
    program's place) instead, the program's and the other readings kept in
    ``run.readings``."""
    state["trainer"] = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    got = readings(run, state, "program")
    run.readings = dict(got)
    if run.control:
        for precision in ("fp8", "int8"):
            run.readings[precision] = readings(run, state, precision)
        got = run.readings[run.traffic["control"]]
        half = torch.arange(run.traffic["batch"] // 2)
        run.readings["half_batch"] = readings(run, state, "float32", half)
    shutil.rmtree(state["corpus"], ignore_errors=True)
    return {k: harness.limit(run, k, got[k]) for k in run.cell.limits}

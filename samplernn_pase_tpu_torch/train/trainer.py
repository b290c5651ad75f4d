"""The TBPTT trainer, as ``samplernn_pase_tpu.train.trainer``: the step
functions (``make_train_step``, ``make_eval_step`` and their multi-step
forms), the plugin hooks (logging, validation, checkpoints, sample
generation) and the ``Trainer`` loop over a ``WavCorpus``.

A step resets the hiddens of lanes whose reset flag is set, runs the
teacher-forced loss, and returns the new hiddens detached: the step
boundary is the TBPTT cut (the reference's ``hidden.detach()``).  As in
the reference, ``reset_state`` reads the parameters outside the
differentiated function, so a learned ``h0`` gets no gradient from a
step and Adam leaves it as it is.  Parameters and optimizer state come
back as new trees.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from samplernn_pase_tpu_torch.config import SampleRNNConfig, TrainConfig
from samplernn_pase_tpu_torch.data.dataset import device_put_batch
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.parallel import mesh as pm
from samplernn_pase_tpu_torch.train.optim import (
    Optimizer, apply_updates, make_optimizer)
from samplernn_pase_tpu_torch.tree import (
    tree_leaves, tree_map, tree_unflatten)


def _reset(params, cfg, hiddens, resets):
    with torch.no_grad():
        return samplernn.reset_state(params, cfg,
                                     tuple(h.detach() for h in hiddens),
                                     resets)


def _grads(nll, p, mesh):
    """d nll / d p as a tree (zeros where unused), summed over the mesh's
    ``data`` axis."""
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(nll, leaves, allow_unused=True)
    grads = tree_unflatten(p, [torch.zeros_like(x) if g is None else g
                               for x, g in zip(leaves, grads)])
    return pm.all_reduce_grads(grads, mesh)


def _train_one(cfg, tx, params, opt_state, hiddens, inputs, targets, resets,
               cond, speakers, valid, mesh=None):
    hiddens = _reset(params, cfg, hiddens, resets)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    nll, new_h = samplernn.loss_fn(p, cfg, inputs, targets, hiddens, cond,
                                   speakers, valid, mesh)
    grads = _grads(nll, p, mesh)
    updates, opt_state = tx.update(grads, opt_state, params, mesh=mesh)
    params = apply_updates(params, updates)
    return (params, opt_state, tuple(h.detach() for h in new_h),
            samplernn.global_nll(nll, mesh))


def make_train_step(cfg: SampleRNNConfig, tx: Optimizer, mesh=None):
    """The TBPTT train step: (params, opt_state, hiddens, inputs, targets,
    resets[, cond, speakers, valid]) -> (params, opt_state, hiddens,
    nll_bits).

    Under ``mesh`` (``parallel.mesh``) the batch arguments and hiddens are
    this rank's block over ``data`` (``batch_sharding``,
    ``state_sharding``), parameters and optimizer state are replicated or,
    on a ``model`` axis > 1, this rank's MLP shards (``shard_params``),
    the gradients are summed over ``data`` before clipping, and the NLL
    returned is the whole batch's."""

    def step(params, opt_state, hiddens, inputs, targets, resets, cond=None,
             speakers=None, valid=None):
        return _train_one(cfg, tx, params, opt_state, hiddens, inputs,
                          targets, resets, cond, speakers, valid, mesh)

    return step


def _at(v, k):
    return None if v is None else v[k]


def make_multi_train_step(cfg: SampleRNNConfig, tx: Optimizer, mesh=None):
    """K train steps in one call: batches staged as [K, B, ...] (under
    ``mesh``, this rank's block of axis 1: ``staged_sharding``); the math
    is K single steps.  Returns (params, opt_state, hiddens, nlls [K])."""

    def multi(params, opt_state, hiddens, xs, ys, rs, cond=None,
              speakers=None, valid=None):
        nlls = []
        for k in range(xs.shape[0]):
            params, opt_state, hiddens, nll = _train_one(
                cfg, tx, params, opt_state, hiddens, xs[k], ys[k], rs[k],
                _at(cond, k), _at(speakers, k), _at(valid, k), mesh)
            nlls.append(nll)
        return params, opt_state, hiddens, torch.stack(nlls)

    return multi


def _eval_one(cfg, params, hiddens, inputs, targets, resets, cond, speakers,
              valid, mesh=None):
    with torch.no_grad():
        hiddens = _reset(params, cfg, hiddens, resets)
        nll, new_h = samplernn.loss_fn(params, cfg, inputs, targets, hiddens,
                                       cond, speakers, valid, mesh)
    return new_h, samplernn.global_nll(nll, mesh)


def make_eval_step(cfg: SampleRNNConfig, mesh=None):
    """(params, hiddens, inputs, targets, resets[, cond, speakers, valid])
    -> (hiddens, nll_bits), without gradients; under ``mesh`` as
    ``make_train_step``, the NLL the whole batch's."""

    def step(params, hiddens, inputs, targets, resets, cond=None,
             speakers=None, valid=None):
        return _eval_one(cfg, params, hiddens, inputs, targets, resets, cond,
                         speakers, valid, mesh)

    return step


def make_multi_eval_step(cfg: SampleRNNConfig, mesh=None):
    """K staged eval batches [K, B, ...] in one call; returns (hiddens,
    nlls [K]), each the masked mean of its (whole) batch."""

    def multi(params, hiddens, xs, ys, rs, cond=None, speakers=None,
              valid=None):
        nlls = []
        for k in range(xs.shape[0]):
            hiddens, nll = _eval_one(cfg, params, hiddens, xs[k], ys[k],
                                     rs[k], _at(cond, k), _at(speakers, k),
                                     _at(valid, k), mesh)
            nlls.append(nll)
        return hiddens, torch.stack(nlls)

    return multi


class Plugin:
    """Trainer hook interface.  All hooks are optional."""

    def on_train_start(self, trainer):  # noqa: D102
        pass

    def on_step(self, trainer, step: int, metrics: dict):
        pass

    def on_epoch_end(self, trainer, epoch: int):
        pass

    def on_train_end(self, trainer):
        pass


class LoggerPlugin(Plugin):
    def __init__(self, writer, every: int = 10):
        self.writer, self.every = writer, every

    def on_step(self, trainer, step, metrics):
        if step % self.every == 0 and trainer.is_chief:
            self.writer.write(step=step, split="train", **metrics)

    def on_epoch_end(self, trainer, epoch):
        if trainer.is_chief:
            self.writer.write(epoch=epoch, event="epoch_end")


class ValidationPlugin(Plugin):
    def __init__(self, writer, every_steps: int = 500):
        self.writer, self.every = writer, every_steps

    def _record(self, trainer, nll, **where):
        # every rank validates (the eval steps sum over the mesh); the
        # chief writes
        trainer.last_val_nll = nll
        if not trainer.is_chief:
            return
        extra = {}
        if trainer.val_is_train_fallback:
            # the corpus has no val split and the batcher fell back to the
            # train split: tag the metric so that neither readers nor the
            # best-checkpoint choice take it for held-out NLL
            extra["val_is_train_fallback"] = True
        self.writer.write(split="val", nll_bits=nll, **where, **extra)

    def on_step(self, trainer, step, metrics):
        if self.every and step > 0 and step % self.every == 0:
            self._record(trainer, trainer.validate(), step=step)

    def on_epoch_end(self, trainer, epoch):
        self._record(trainer, trainer.validate(), epoch=epoch)


class CheckpointPlugin(Plugin):
    def __init__(self, manager, every_steps: int = 500):
        self.mgr, self.every = manager, every_steps

    def _save(self, trainer, step, next_step):
        # val NLL drives best-checkpoint retention; a train-split fallback
        # NLL must not choose the best checkpoint
        metrics = None
        if (trainer.last_val_nll is not None
                and not trainer.val_is_train_fallback):
            metrics = {"val_nll_bits": float(trainer.last_val_nll)}
        # cursor = (epoch, last trained batch idx, next global step):
        # restore() skips batches <= batch_idx and numbers the first batch
        # after the resume next_step, so nothing is trained or logged twice.
        # Under a mesh every rank gathers the hiddens (a collective), then
        # the chief alone writes the unsharded checkpoint
        hiddens = pm.gather_state(trainer.data_mesh, trainer.hiddens)
        if not trainer.is_chief:
            return
        self.mgr.save(
            step, trainer._ckpt_params(), trainer.opt_state, hiddens,
            cursor=np.asarray([trainer.epoch, trainer.batch_idx,
                               next_step]),
            metrics=metrics)

    def on_step(self, trainer, step, metrics):
        if self.every and step > 0 and step % self.every == 0:
            # trainer.params are those at the end of the current group
            # (steps_per_call), so the resume point is the group's end even
            # when the cadence fires inside it; else the group's tail would
            # be numbered again onto new data
            self._save(trainer, step,
                       max(step + 1, trainer.resume_next_step))

    def on_train_end(self, trainer):
        self._save(trainer, trainer.global_step, trainer.global_step)
        self.mgr.wait()


class GeneratorPlugin(Plugin):
    """Writes generated wavs every ``every_steps`` steps.

    A conditioned model generates conditioned audio: pass ``speakers``
    (per-sequence ids for n_speakers models) and/or ``cond`` (a [n_seqs,
    frames, cond_dim] stream).  With neither, a speaker model defaults to
    one sequence per speaker id (0..n-1), so the artifacts take the model's
    real path.  The noise is keyed by the global step (``seed``)."""

    def __init__(self, out_dir, every_steps: int, n_seqs: int = 2,
                 length: int = 16_000, sample_rate: int = 16_000,
                 temperature: float = 1.0, speakers=None, cond=None):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every, self.n, self.length = every_steps, n_seqs, length
        self.sr, self.temp = sample_rate, temperature
        self.speakers = (None if speakers is None
                         else np.asarray(speakers, np.int32))
        self.cond = None if cond is None else np.asarray(cond, np.float32)

    def _cond_args(self, trainer):
        from samplernn_pase_tpu_torch.generate import fit_cond_stream
        cfg = trainer.model_cfg
        speakers, cond, n = self.speakers, self.cond, self.n
        if speakers is not None:
            n = len(speakers)
        if cond is not None:
            if speakers is not None and len(speakers) != cond.shape[0]:
                raise ValueError(
                    f"GeneratorPlugin: {len(speakers)} speaker ids but "
                    f"{cond.shape[0]} conditioning sequences")
            n = cond.shape[0]
            cond = fit_cond_stream(cond, -(-self.length // cfg.cond_rate))
        if cond is None and cfg.cond_dim:
            # no static stream: ask the trainer (a joint trainer embeds a
            # corpus utterance through its current encoder)
            need = -(-self.length // cfg.cond_rate)
            gen_cond = getattr(trainer, "generation_cond", None)
            dyn = gen_cond(n, need) if gen_cond is not None else None
            if dyn is not None:
                cond = np.asarray(dyn, np.float32)
        if speakers is None and cfg.n_speakers:
            # n_speakers models always add the speaker embedding to the
            # conditioning in training, so decode with ids too
            speakers = np.arange(n, dtype=np.int32) % cfg.n_speakers
        return n, speakers, cond

    def _generate(self, trainer, tag):
        from samplernn_pase_tpu_torch import generate as gen
        from samplernn_pase_tpu_torch.ops.audio_io import write_wav
        n, speakers, cond = self._cond_args(trainer)
        params = getattr(trainer, "gen_params", None)
        if params is None:
            params = trainer.params
        wav = gen.generate(
            params, trainer.model_cfg, n_seqs=n, length=self.length,
            temperature=self.temp, seed=trainer.global_step, cond=cond,
            speakers=speakers, device=trainer.device).cpu().numpy()
        for i in range(n):
            spk = f"_spk{int(speakers[i])}" if speakers is not None else ""
            write_wav(self.dir / f"{tag}_seq{i}{spk}.wav", wav[i], self.sr)

    def on_step(self, trainer, step, metrics):
        # the chief alone generates (no collective inside)
        if (self.every and step > 0 and step % self.every == 0
                and trainer.is_chief):
            self._generate(trainer, f"step{step:08d}")


class Trainer:
    """Epoch/step loop over a WavCorpus with TBPTT state plumbing.

    ``device``: where to train (default CUDA, which must be present);
    ``params``: a starting parameter tree (else drawn from ``seed``,
    default ``train_cfg.seed``).  ``host_s`` accumulates the host's wall
    time by part of the loop: reading batches ("data"), staging them on
    the device ("stage"), launching steps ("dispatch"), waiting for a
    group's NLLs ("sync") and running plugin hooks ("plugins").  With
    ``train_cfg.profile_dir``, steps 10-12 are traced with torch.profiler
    into that directory, and ``profile`` holds the trace (its profiler and
    the traced span's wall time).

    ``mesh`` (``parallel.mesh``; one process per rank): the batch and the
    hiddens are split over its ``data`` axis, parameters and optimizer
    state replicated (a ``model`` axis only repeats the work, as the
    reference's ``Trainer`` replicates params).  Every rank reads the
    same corpus in the same order and trains on its block of each batch;
    ``device`` is the rank's own (``parallel.mesh.rank_device``) and every
    rank must start from the same parameters (``seed``).  Files are
    written by the chief alone (``is_chief``): the logger's and the
    validation's lines, the checkpoints (unsharded, the hiddens gathered
    first on every rank) and the generated wavs."""

    def __init__(self, model_cfg: SampleRNNConfig, train_cfg: TrainConfig,
                 corpus, plugins: Sequence[Plugin] = (), params=None,
                 seed: int | None = None, device=None, mesh=None):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.corpus = corpus
        self.plugins = list(plugins)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data_mesh = pm.data_mesh(mesh)
        dp = pm.axis_size(mesh, "data")
        if train_cfg.batch_size % dp:
            raise ValueError(f"batch_size={train_cfg.batch_size} must divide "
                             f"over the mesh data axis ({dp})")
        self.local_batch = train_cfg.batch_size // dp
        seed = seed if seed is not None else train_cfg.seed
        self.params = (tree_map(lambda t: t.to(self.device), params)
                       if params is not None else self._init_params(seed))
        self.tx = make_optimizer(
            train_cfg.lr, train_cfg.grad_clip,
            schedule=train_cfg.lr_schedule,
            warmup_steps=train_cfg.warmup_steps,
            decay_steps=train_cfg.decay_steps)
        self.opt_state = self.tx.init(self.params)
        self.hiddens = samplernn.initial_state(
            self._model_params(), model_cfg, self.local_batch)
        self._build_steps()
        self.global_step = 0
        self.epoch = 0
        self.batch_idx = 0
        self._resume_batch_idx = -1   # -1 = not resuming (0 is a valid idx)
        self.resume_next_step = 0     # step number a resume starts at: the
                                      # end of the current group
        self.profile = None
        self._tracing = False
        self._pending = None          # in-flight group (see _run_group)
        self.last_val_nll = None
        # True when the corpus has no held-out split and "val" batches
        # reuse train data (see ValidationPlugin/CheckpointPlugin)
        self.val_is_train_fallback = not getattr(corpus, "has_val", True)
        self.host_s = dict.fromkeys(
            ("data", "stage", "dispatch", "sync", "plugins"), 0.0)

    # -- mode hooks (overridden by a joint trainer) ----------------------
    metric_tags: dict = {}   # extra key/values stamped onto step metrics

    @property
    def is_chief(self) -> bool:
        """Whether this process writes the run's files (always, without a
        mesh)."""
        return pm.is_chief(self.mesh)

    def _init_params(self, seed):
        return samplernn.init_params(torch.Generator().manual_seed(seed),
                                     self.model_cfg, self.device)

    def _model_params(self):
        """The SampleRNN half of self.params (all of it in plain mode)."""
        return self.params

    def _build_steps(self):
        multi = self.train_cfg.steps_per_call > 1
        m, mesh = self.model_cfg, self.data_mesh
        self._train_step = make_train_step(m, self.tx, mesh)
        self._multi_step = (make_multi_train_step(m, self.tx, mesh)
                            if multi else None)
        self._eval_step = make_eval_step(m, mesh)
        self._multi_eval_step = (make_multi_eval_step(m, mesh)
                                 if multi else None)

    def _ckpt_params(self):
        """What goes into the checkpoint's "params" slot."""
        return self.params

    def _set_ckpt_params(self, p):
        self.params = p

    @property
    def gen_params(self):
        """Params for the GeneratorPlugin's decode."""
        return self._model_params()

    def generation_cond(self, n_seqs: int, n_frames: int):
        """Conditioning stream [n_seqs, n_frames, cond_dim] for periodic
        generation when the plugin has no static stream; None = generate
        without external conditioning."""
        return None

    # -- data ------------------------------------------------------------
    def _batcher(self, split):
        shuffle_seed = None
        if split == "train" and self.train_cfg.shuffle:
            shuffle_seed = self.train_cfg.seed * 100_003 + self.epoch
        return self.corpus.batcher(
            split, self.train_cfg.batch_size, self.train_cfg.seq_len,
            self.model_cfg.lookback,
            cond_rate=self.model_cfg.cond_rate or None,
            shuffle_seed=shuffle_seed)

    def _timed(self, items):
        """Iterate ``items``, adding the time spent in them to "data"."""
        it = iter(items)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self.host_s["data"] += time.perf_counter() - t0
            yield item

    def _put(self, *arrays, dim: int = 0):
        """Host arrays on the device: under a mesh, this rank's block of
        their batch axis ``dim`` (0, or 1 for [K, B, ...] stages)."""
        shard = pm.Sharding(self.data_mesh, dim).shard
        return device_put_batch(tuple(shard(a) for a in arrays), self.device)

    @staticmethod
    def _split_batch(item):
        if isinstance(item, tuple) and len(item) == 2:
            chunk, cond = item
        else:
            chunk, cond = item, None
        return chunk, cond

    @staticmethod
    def _needs_mask(chunk) -> bool:
        """True when the batch carries q_zero tail padding that the loss
        must mask.  Fully valid batches (every interior chunk) skip the
        mask: the unmasked mean is the same number."""
        return (chunk.valid is not None
                and bool(np.any(chunk.valid < chunk.targets.shape[-1])))

    def _cond_kwargs(self, chunk, cond):
        kwargs = {}
        if cond is not None:
            kwargs["cond"] = self._put(cond)[0]
        if self.model_cfg.n_speakers and chunk.speakers is not None:
            kwargs["speakers"] = self._put(chunk.speakers)[0]
        return kwargs

    # -- loops -----------------------------------------------------------
    def run(self, epochs: int | None = None):
        epochs = epochs if epochs is not None else self.train_cfg.epochs
        for p in self.plugins:
            p.on_train_start(self)
        samples_per_chunk = (self.train_cfg.batch_size
                             * self.train_cfg.seq_len)
        skip_until = self._resume_batch_idx   # -1 unless resuming
        self._resume_batch_idx = -1
        self._pending = None
        k_call = max(1, self.train_cfg.steps_per_call)
        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            group: list = []
            try:
                for i, item in enumerate(self._timed(self._batcher("train"))):
                    if i <= skip_until:
                        # exact mid-epoch resume: the checkpoint carries
                        # the data cursor (the last trained index) and the
                        # hidden states, so trained chunks are skipped
                        continue
                    group.append((i, item))
                    if len(group) == k_call:
                        self._run_group(group, samples_per_chunk)
                        group = []
                # an epoch tail shorter than steps_per_call runs through
                # the single-step path
                for it in group:
                    self._run_group([it], samples_per_chunk)
            except BaseException:
                # the pending group is trained on the device already: fire
                # its hooks (checkpoint cadence included) before the
                # exception propagates, so no durable progress is lost; a
                # failure inside that flush must not replace the exception
                try:
                    self._flush_pending()
                except Exception as flush_exc:
                    print("[trainer] pending-group flush failed while "
                          f"unwinding another exception: {flush_exc!r}",
                          file=sys.stderr)
                raise
            # the epoch-end hooks (validation, epoch logs) see the whole
            # epoch trained
            self._flush_pending()
            skip_until = -1
            for p in self.plugins:
                p.on_epoch_end(self, epoch)
        self._flush_pending()
        for p in self.plugins:
            p.on_train_end(self)
        return self

    def _run_group(self, group, samples_per_chunk):
        """Train a group of consecutive chunks: one multi-step call when
        the group has more than one item, else the single-step path.

        Pipelined: the next group is staged on the device while the
        previous one computes, then the previous group is flushed (its
        NLLs read and its plugin hooks fired) before this group is
        launched, so every plugin sees the state its step number implies.
        The data cursor (batch_idx) is pinned to the group's last index at
        launch, so a checkpoint taken inside the group never makes chunks
        already folded into the saved params train again."""
        t0 = time.perf_counter()
        staged = self._stage_group(group)   # overlaps the previous group
        self.host_s["stage"] += time.perf_counter() - t0
        self._flush_pending()               # plugins of the previous group
        # profiling (the chief's): trace from the launch that covers step
        # 10 until step 12 has run
        if (self.train_cfg.profile_dir and self.profile is None
                and self.is_chief
                and self.global_step <= 10 < self.global_step + len(group)):
            from samplernn_pase_tpu_torch.utils.profiling import Trace
            self.profile = Trace(self.train_cfg.profile_dir).start()
            self._tracing = True
        t0 = time.perf_counter()
        self.batch_idx = group[-1][0]
        kind, args, kwargs = staged
        if kind == "single":
            nlls = self._step_single(args, kwargs)
        else:
            nlls = self._step_multi(args, kwargs)
        self.host_s["dispatch"] += time.perf_counter() - t0
        self._pending = (nlls, len(group), t0, samples_per_chunk)

    def _stage_group(self, group):
        """Assemble one group's batches on the host and copy them to the
        device without blocking (pinned memory on CUDA)."""
        if len(group) == 1:
            chunk, cond = self._split_batch(group[0][1])
            args = self._put(chunk.inputs, chunk.targets,
                             chunk.resets.astype(np.float32))
            kwargs = self._cond_kwargs(chunk, cond)
            if self._needs_mask(chunk):
                kwargs["valid"] = self._put(chunk.valid)[0]
            return ("single", args, kwargs)
        chunks, conds = zip(*(self._split_batch(it) for _, it in group))
        xs, ys, rs = self._put(
            np.stack([c.inputs for c in chunks]),
            np.stack([c.targets for c in chunks]),
            np.stack([c.resets for c in chunks]).astype(np.float32), dim=1)
        kwargs = {}
        if conds[0] is not None:
            kwargs["cond"] = self._put(np.stack(conds), dim=1)[0]
        if (self.model_cfg.n_speakers
                and chunks[0].speakers is not None):
            kwargs["speakers"] = self._put(
                np.stack([c.speakers for c in chunks]), dim=1)[0]
        if any(self._needs_mask(c) for c in chunks):
            kwargs["valid"] = self._put(
                np.stack([c.valid for c in chunks]), dim=1)[0]
        return ("multi", (xs, ys, rs), kwargs)

    def _flush_pending(self):
        """Read the pending group's NLLs (the loop's one host sync per
        group) and fire its plugin hooks.  No-op when nothing is
        pending."""
        if self._pending is None:
            return
        nlls_obj, n_group, t0, samples_per_chunk = self._pending
        self._pending = None
        t1 = time.perf_counter()
        nlls = [float(v) for v in nlls_obj.reshape(-1).tolist()]
        t2 = time.perf_counter()
        self.host_s["sync"] += t2 - t1
        dt = (t2 - t0) / n_group
        if self._tracing and self.global_step + n_group > 12:
            self.profile.stop()
            self._tracing = False
        self.resume_next_step = self.global_step + len(nlls)
        for nll in nlls:
            metrics = {
                **self.metric_tags,
                "nll_bits": nll,
                "samples_per_sec": samples_per_chunk / dt,
                "frames_per_sec": (samples_per_chunk
                                   / self.model_cfg.frame_sizes[0] / dt),
            }
            for p in self.plugins:
                p.on_step(self, self.global_step, metrics)
            self.global_step += 1
        self.host_s["plugins"] += time.perf_counter() - t2

    def _step_single(self, args, kwargs):
        """One train step; returns its NLL as a device tensor (read by
        _flush_pending, so the next group's upload overlaps this
        group's compute)."""
        (self.params, self.opt_state, self.hiddens,
         nll) = self._train_step(
            self.params, self.opt_state, self.hiddens, *args, **kwargs)
        return nll

    def _step_multi(self, staged, kwargs):
        """K staged train steps in one call; device NLL tensor [K]."""
        (self.params, self.opt_state, self.hiddens,
         nll_arr) = self._multi_step(
            self.params, self.opt_state, self.hiddens, *staged, **kwargs)
        return nll_arr

    def _eval_call(self, hiddens, args, kwargs):
        return self._eval_step(self.params, hiddens, *args, **kwargs)

    def _multi_eval_call(self, hiddens, staged, kwargs):
        return self._multi_eval_step(self.params, hiddens, *staged,
                                     **kwargs)

    @staticmethod
    def _chunk_weight(chunk) -> float:
        """Valid (non-padding) target samples in a batch: the weight of
        its masked-mean NLL in the split's aggregate."""
        if chunk.valid is not None:
            return float(np.sum(chunk.valid))
        return float(np.size(chunk.targets))

    def _val_group(self, group, hiddens, nll_parts, w_parts):
        """One validation call (K staged batches, or one).  NLLs stay on
        the device until the end of the split."""
        kind, args, kwargs = self._stage_group(
            [(0, it) for it in group])
        if kind == "single":
            hiddens, nll = self._eval_call(hiddens, args, kwargs)
        else:
            hiddens, nll = self._multi_eval_call(hiddens, args, kwargs)
        nll_parts.append(nll.reshape(-1))
        w_parts.append(np.asarray(
            [self._chunk_weight(self._split_batch(it)[0])
             for it in group]))
        return hiddens

    def validate(self) -> float:
        """Valid-sample-weighted held-out NLL (bits/sample): each batch's
        masked mean is weighted by its count of real samples, so padded
        tails neither score padding nor dilute the average.  Under a mesh
        every rank must call it (each batch's NLL is summed over the
        ranks) and every rank gets the same number."""
        hiddens = samplernn.initial_state(
            self._model_params(), self.model_cfg, self.local_batch)
        k_call = (max(1, self.train_cfg.steps_per_call)
                  if self._multi_eval_step is not None else 1)
        group, nll_parts, w_parts = [], [], []
        for item in self._batcher("val"):
            group.append(item)
            if len(group) == k_call:
                hiddens = self._val_group(group, hiddens, nll_parts,
                                          w_parts)
                group = []
        for it in group:   # tail: single-step path (see run())
            hiddens = self._val_group([it], hiddens, nll_parts, w_parts)
        if not nll_parts:
            return 0.0
        nlls = torch.cat(nll_parts).cpu().numpy()
        ws = np.concatenate(w_parts)
        return float(np.sum(nlls * ws) / max(np.sum(ws), 1.0))

    # -- resume ----------------------------------------------------------
    def restore(self, manager, step: int | None = None) -> bool:
        """Restore the checkpoint at ``step`` (default the latest) onto
        this trainer's device; False when there is none.  Under a mesh
        every rank reads the (unsharded) checkpoint and keeps its block of
        the hiddens, so a checkpoint moves between meshes and sizes."""
        template = {"params": self._ckpt_params(),
                    "opt_state": self.opt_state,
                    "hiddens": list(self.hiddens)}
        restored = manager.restore(step, template=template)
        if restored is None:
            return False
        self._set_ckpt_params(restored["params"])
        self.opt_state = restored["opt_state"]
        if restored.get("hiddens") is not None:
            self.hiddens = pm.shard_state(self.data_mesh,
                                          tuple(restored["hiddens"]))
        cursor = restored.get("cursor")
        if cursor is not None:
            self.epoch = int(cursor[0])
            self._resume_batch_idx = int(cursor[1])
            if np.size(cursor) >= 3:
                self.global_step = int(cursor[2])
            else:
                # a 2-element cursor: the saved step was trained, so the
                # next batch is numbered after it
                self.global_step = int(restored["step"]) + 1
        else:
            # no cursor: number the first batch after the saved step
            self.global_step = int(restored["step"]) + 1
        return True

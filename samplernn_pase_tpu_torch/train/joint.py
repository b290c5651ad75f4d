"""Joint PASE + SampleRNN end-to-end training, as
``samplernn_pase_tpu.train.joint`` (config 4's "embeddings upsampled into
frame tiers, end-to-end training").

The encoder runs inside the train step on the chunk's waveform, and the
SampleRNN NLL is backpropagated into it, so the conditioning adapts to
the task.  The waveform is the chunk's levels decoded with the model's
codec: mu-law through K7 (``ops/kernels/codec.py``, its plain version on
CPU tensors), reading the levels' strided view in place; no gradient
flows into the levels.  A step differentiates the joint tree
``{"srnn", "pase"}`` with ``torch.autograd.grad`` under
``pase.conv_numerics`` (deterministic cuDNN convolutions and gradients),
and returns the encoder's new BatchNorm state without autograd history.

``JointTrainer`` drives this mode through the ``Trainer`` loop:
validation with joint conditioning, checkpoints with the payload
``{"joint": {"srnn", "pase"}, "bn": bn_state}`` at the trainer's cadence
(exact mid-epoch resume), conditioned generation through the current
encoder, and ``steps_per_call`` groups.  ``freeze_pase`` stops the
gradient at the embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from samplernn_pase_tpu_torch import generate
from samplernn_pase_tpu_torch.config import PASEConfig, SampleRNNConfig
from samplernn_pase_tpu_torch.models import pase as pase_mod
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.train.optim import Optimizer, apply_updates
from samplernn_pase_tpu_torch.parallel.mesh import axis_group
from samplernn_pase_tpu_torch.train.trainer import (
    LoggerPlugin, Plugin, Trainer, _at, _grads, _reset)
from samplernn_pase_tpu_torch.tree import tree_map


def init_joint(gen: torch.Generator, model_cfg: SampleRNNConfig,
               pase_cfg: PASEConfig, pase_params=None, bn_state=None,
               device=None):
    """(params, bn_state) with params = {"srnn": ..., "pase": ...}: the
    SampleRNN drawn from ``gen`` first, then the encoder (unless
    ``pase_params`` and ``bn_state`` are given), on ``device``."""
    if (pase_params is None) != (bn_state is None):
        raise ValueError("pase_params and bn_state come together")
    srnn = samplernn.init_params(gen, model_cfg, device)
    if pase_params is None:
        pase_params, bn_state = pase_mod.init_pase(gen, pase_cfg, device)
    else:
        dev = srnn["mlp"]["b_out"].device
        pase_params, bn_state = tree_map(lambda t: t.to(dev),
                                         (pase_params, bn_state))
    return {"srnn": srnn, "pase": pase_params}, bn_state


def joint_cond(pase_params, bn_state, model_cfg, pase_cfg, inputs, *,
               train: bool, mesh=None):
    """Chunk levels [B, lookback + T] -> (cond [B, T // decimation, D],
    bn_state), the encoder fed the chunk's waveform through the model's
    codec, so it sees the audio the quantizer encoded.  Under ``mesh`` the
    chunk is this rank's block and train-mode BatchNorm takes the whole
    batch's statistics."""
    wav = generate.decode_waveform(inputs[:, model_cfg.lookback:], model_cfg)
    return pase_mod.pase_apply(pase_params, bn_state, wav, pase_cfg,
                               train=train, group=axis_group(mesh, "data"))


def _check_cfgs(model_cfg, pase_cfg):
    if model_cfg.cond_dim != pase_cfg.emb_dim:
        raise ValueError("model_cfg.cond_dim must equal pase emb_dim")
    if model_cfg.cond_rate != pase_cfg.decimation:
        raise ValueError("model_cfg.cond_rate must equal pase decimation")


def _train_one(mcfg, pcfg, tx, freeze_pase, params, opt_state, bn_state,
               hiddens, inputs, targets, resets, speakers, valid, mesh=None):
    hiddens = _reset(params["srnn"], mcfg, hiddens, resets)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with pase_mod.conv_numerics():
        cond, new_bn = joint_cond(p["pase"], bn_state, mcfg, pcfg, inputs,
                                  train=True, mesh=mesh)
        if freeze_pase:
            cond = cond.detach()
        nll, new_h = samplernn.loss_fn(p["srnn"], mcfg, inputs, targets,
                                       hiddens, cond, speakers, valid, mesh)
        grads = _grads(nll, p, mesh)
    updates, opt_state = tx.update(grads, opt_state, params, mesh=mesh)
    params = apply_updates(params, updates)
    return (params, opt_state, new_bn, tuple(h.detach() for h in new_h),
            samplernn.global_nll(nll, mesh))


def make_joint_train_step(model_cfg: SampleRNNConfig, pase_cfg: PASEConfig,
                          tx: Optimizer, freeze_pase: bool = False,
                          mesh=None):
    """The end-to-end step over {"srnn", "pase"}: (params, opt_state,
    bn_state, hiddens, inputs, targets, resets[, speakers, valid]) ->
    (params, opt_state, bn_state, hiddens, nll_bits).  Under ``mesh`` as
    ``trainer.make_train_step``: the encoder is replicated, its gradients
    are summed over ``data`` with the SampleRNN half's, and its BatchNorm
    takes the whole batch's statistics."""
    _check_cfgs(model_cfg, pase_cfg)

    def step(params, opt_state, bn_state, hiddens, inputs, targets, resets,
             speakers=None, valid=None):
        return _train_one(model_cfg, pase_cfg, tx, freeze_pase, params,
                          opt_state, bn_state, hiddens, inputs, targets,
                          resets, speakers, valid, mesh)

    return step


def make_joint_multi_step(model_cfg: SampleRNNConfig, pase_cfg: PASEConfig,
                          tx: Optimizer, freeze_pase: bool = False,
                          mesh=None):
    """K joint steps in one call, batches staged [K, B, ...]; the math is
    K single steps.  Returns (params, opt_state, bn_state, hiddens, nlls
    [K])."""
    _check_cfgs(model_cfg, pase_cfg)

    def multi(params, opt_state, bn_state, hiddens, xs, ys, rs,
              speakers=None, valid=None):
        nlls = []
        for k in range(xs.shape[0]):
            params, opt_state, bn_state, hiddens, nll = _train_one(
                model_cfg, pase_cfg, tx, freeze_pase, params, opt_state,
                bn_state, hiddens, xs[k], ys[k], rs[k], _at(speakers, k),
                _at(valid, k), mesh)
            nlls.append(nll)
        return params, opt_state, bn_state, hiddens, torch.stack(nlls)

    return multi


def _eval_one(mcfg, pcfg, params, bn_state, hiddens, inputs, targets, resets,
              speakers, valid, mesh=None):
    with torch.no_grad():
        hiddens = _reset(params["srnn"], mcfg, hiddens, resets)
        cond, _ = joint_cond(params["pase"], bn_state, mcfg, pcfg, inputs,
                             train=False)
        nll, new_h = samplernn.loss_fn(params["srnn"], mcfg, inputs,
                                       targets, hiddens, cond, speakers,
                                       valid, mesh)
    return new_h, samplernn.global_nll(nll, mesh)


def make_joint_eval_step(model_cfg: SampleRNNConfig, pase_cfg: PASEConfig,
                         mesh=None):
    """Held-out NLL with joint conditioning (the encoder in eval mode:
    running statistics, no update): (params, bn_state, hiddens, inputs,
    targets, resets[, speakers, valid]) -> (hiddens, nll_bits)."""
    _check_cfgs(model_cfg, pase_cfg)

    def step(params, bn_state, hiddens, inputs, targets, resets,
             speakers=None, valid=None):
        return _eval_one(model_cfg, pase_cfg, params, bn_state, hiddens,
                         inputs, targets, resets, speakers, valid, mesh)

    return step


def make_joint_multi_eval_step(model_cfg: SampleRNNConfig,
                               pase_cfg: PASEConfig, mesh=None):
    """K staged joint eval batches [K, B, ...] in one call; returns
    (hiddens, nlls [K])."""
    _check_cfgs(model_cfg, pase_cfg)

    def multi(params, bn_state, hiddens, xs, ys, rs, speakers=None,
              valid=None):
        nlls = []
        for k in range(xs.shape[0]):
            hiddens, nll = _eval_one(model_cfg, pase_cfg, params, bn_state,
                                     hiddens, xs[k], ys[k], rs[k],
                                     _at(speakers, k), _at(valid, k), mesh)
            nlls.append(nll)
        return hiddens, torch.stack(nlls)

    return multi


def _zero_pase_bias_moments(tree):
    """``tree`` with every "b" leaf under its "pase" key zeroed."""
    def walk(node, in_pase):
        if isinstance(node, dict):
            return {k: (torch.zeros_like(v) if in_pase and k == "b"
                        else walk(v, in_pase or k == "pase"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, in_pase) for v in node)
        return node
    return walk(tree, False)


class JointTrainer(Trainer):
    """The ``Trainer`` loop for the joint model: the same plugins, epochs,
    ``steps_per_call`` groups and exact mid-epoch resume, with steps that
    carry the encoder's (params, bn_state) and compute the conditioning
    from the chunk.  The checkpoint's params slot is ``{"joint": {"srnn",
    "pase"}, "bn": bn_state}``.  ``seed`` draws the SampleRNN and then the
    encoder (unless ``pase_params`` and ``bn_state`` are given);
    ``params`` (the joint tree) needs ``bn_state``.  A corpus with cached
    conditioning is refused: the conditioning comes from the encoder.
    ``mesh`` as ``Trainer``'s: the encoder and its BatchNorm state are
    replicated, and stay equal on every rank (the statistics are the whole
    batch's; a restore reads the same state everywhere)."""

    metric_tags = {"mode": "joint"}

    def __init__(self, model_cfg: SampleRNNConfig, pase_cfg: PASEConfig,
                 train_cfg, corpus, plugins=(), params=None, bn_state=None,
                 seed: int | None = None, freeze_pase: bool = False,
                 pase_params=None, device=None, mesh=None):
        _check_cfgs(model_cfg, pase_cfg)
        if getattr(corpus, "conditioning", None) is not None:
            raise ValueError(
                "joint training computes conditioning in-graph from the "
                "chunk waveform; a corpus with cached embeddings "
                "(--cond-dir) is ambiguous — drop one of the two")
        if params is not None and bn_state is None:
            raise ValueError("explicit params require bn_state")
        self.pase_cfg = pase_cfg
        self.freeze_pase = freeze_pase
        self._pase_init = (pase_params, bn_state)
        self.bn_state = bn_state
        self._migrated_legacy_bias = False
        super().__init__(model_cfg, train_cfg, corpus, plugins,
                         params=params, seed=seed, device=device, mesh=mesh)
        self.bn_state = tree_map(lambda t: t.to(self.device), self.bn_state)

    # -- mode hooks ------------------------------------------------------
    def _init_params(self, seed):
        params, self.bn_state = init_joint(
            torch.Generator().manual_seed(seed), self.model_cfg,
            self.pase_cfg, *self._pase_init, device=self.device)
        return params

    def _model_params(self):
        return self.params["srnn"]

    def _build_steps(self):
        multi = self.train_cfg.steps_per_call > 1
        m, p, mesh = self.model_cfg, self.pase_cfg, self.data_mesh
        self._train_step = make_joint_train_step(
            m, p, self.tx, freeze_pase=self.freeze_pase, mesh=mesh)
        self._multi_step = (make_joint_multi_step(
            m, p, self.tx, freeze_pase=self.freeze_pase, mesh=mesh)
            if multi else None)
        self._eval_step = make_joint_eval_step(m, p, mesh)
        self._multi_eval_step = (make_joint_multi_eval_step(m, p, mesh)
                                 if multi else None)

    def _step_single(self, args, kwargs):
        (self.params, self.opt_state, self.bn_state, self.hiddens,
         nll) = self._train_step(self.params, self.opt_state, self.bn_state,
                                 self.hiddens, *args, **kwargs)
        return nll

    def _step_multi(self, staged, kwargs):
        (self.params, self.opt_state, self.bn_state, self.hiddens,
         nlls) = self._multi_step(self.params, self.opt_state,
                                  self.bn_state, self.hiddens, *staged,
                                  **kwargs)
        return nlls

    def _eval_call(self, hiddens, args, kwargs):
        return self._eval_step(self.params, self.bn_state, hiddens, *args,
                               **kwargs)

    def _multi_eval_call(self, hiddens, staged, kwargs):
        return self._multi_eval_step(self.params, self.bn_state, hiddens,
                                     *staged, **kwargs)

    def _ckpt_params(self):
        return {"joint": self.params, "bn": self.bn_state}

    def _set_ckpt_params(self, p):
        # a checkpoint whose conv blocks still carry a bias: fold it into
        # the running mean and zero the leaf (kept, so the restored Adam
        # state's tree still matches); eval output is unchanged
        pase_p, bn, changed = pase_mod.absorb_legacy_bias(
            p["joint"]["pase"], p["bn"])
        self._migrated_legacy_bias = changed
        dev = self.device
        self.params = tree_map(lambda t: t.to(dev),
                               {"srnn": p["joint"]["srnn"], "pase": pase_p})
        self.bn_state = tree_map(lambda t: t.to(dev), bn)

    def restore(self, manager, step: int | None = None) -> bool:
        ok = super().restore(manager, step)
        if ok:
            dev = self.device
            self.opt_state = tree_map(
                lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
                self.opt_state)
        if ok and self._migrated_legacy_bias:
            # the migrated leaf is zero and unread by the forward, but its
            # restored Adam moments are not: left alone they would move it
            # off zero, and the next restore would fold that drift into
            # the running mean
            self.opt_state = _zero_pase_bias_moments(self.opt_state)
        return ok

    def generation_cond(self, n_seqs: int, n_frames: int):
        """Embed a fixed corpus utterance (held-out when there is one)
        through the current encoder, [n_seqs, n_frames, emb_dim] float32
        numpy, so the GeneratorPlugin's audio takes the conditioned decode
        path."""
        idx = (self.corpus.val_idx or self.corpus.train_idx)[0]
        lv = np.asarray(self.corpus.utterances[idx])
        need = n_frames * self.model_cfg.cond_rate
        if len(lv) < need:   # repeat-pad the tail
            lv = np.concatenate([lv, np.full(need - len(lv), lv[-1],
                                             lv.dtype)])
        lv = torch.from_numpy(lv[None, :need].astype(np.int32)).to(
            self.device)
        with torch.no_grad():
            wav = generate.decode_waveform(lv, self.model_cfg)
            emb, _ = pase_mod.pase_apply(self.params["pase"], self.bn_state,
                                         wav, self.pase_cfg, train=False)
        emb = generate.fit_cond_stream(emb[0], n_frames)
        return np.broadcast_to(emb[None], (n_seqs, *emb.shape))


class _CollectLosses(Plugin):
    """run_joint_training's record of the per-step NLLs."""

    def __init__(self):
        self.losses = []

    def on_step(self, trainer, step, metrics):
        self.losses.append(metrics["nll_bits"])


def run_joint_training(model_cfg: SampleRNNConfig, pase_cfg: PASEConfig,
                       train_cfg, corpus, writer=None, epochs=None,
                       freeze_pase: bool = False, seed: int | None = None,
                       pase_params=None, bn_state=None, device=None):
    """Joint training as one call.  Returns (params, bn_state, losses)."""
    collect = _CollectLosses()
    plugins = [collect]
    if writer is not None:
        plugins.append(LoggerPlugin(writer, train_cfg.log_every_steps))
    t = JointTrainer(model_cfg, pase_cfg, train_cfg, corpus, plugins,
                     seed=seed, freeze_pase=freeze_pase,
                     pase_params=pase_params, bn_state=bn_state,
                     device=device)
    t.run(epochs)
    return t.params, t.bn_state, collect.losses

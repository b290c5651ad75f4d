"""Checkpoint and resume, as ``samplernn_pase_tpu.train.checkpoint``, in
a torch format in place of orbax.

A checkpoint holds the parameters, the optimizer state, each tier's TBPTT
hidden state and the data cursor (epoch, last trained batch, next global
step), so a resume mid-epoch is exact.  Each is one file,
``<step>.pt``: ``torch.save`` of CPU tensors in the port's trees (dicts,
lists and tuples, which a ``weights_only`` load rebuilds as they were),
written to a temporary name and renamed into place.  ``metrics.json``
records each step's metrics, so the best checkpoint is known after a
restart without opening the checkpoints.

Retention is the reference's: the latest ``max_to_keep`` checkpoints
always stay (so ``restore()`` never rewinds training), plus the one with
the lowest ``val_nll_bits``; a checkpoint without that metric never
counts as best.  Restoring without a template returns CPU tensors, so a
checkpoint written on the card loads on the CPU and the other way round.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from samplernn_pase_tpu_torch.tree import tree_map

_METRICS = "metrics.json"


def _to_cpu(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


def _place(restored, template):
    """``restored`` with each leaf on the device and in the dtype of the
    template's leaf at its place; a leaf the template lacks (a tree
    written by an older layout) stays as it was loaded."""
    if isinstance(restored, dict):
        t = template if isinstance(template, dict) else {}
        return {k: _place(v, t.get(k)) for k, v in restored.items()}
    if isinstance(restored, (list, tuple)):
        t = (template if isinstance(template, (list, tuple))
             and len(template) == len(restored) else [None] * len(restored))
        return type(restored)(_place(r, u) for r, u in zip(restored, t))
    if isinstance(restored, torch.Tensor) and isinstance(template,
                                                         torch.Tensor):
        return restored.to(template.device, template.dtype)
    return restored


def _atomic_write(path: Path, write):
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        m = self.dir / _METRICS
        self._metrics = ({int(k): v for k, v in json.loads(
            m.read_text()).items()} if m.exists() else {})

    def _path(self, step: int) -> Path:
        return self.dir / f"{int(step)}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem) for p in self.dir.glob("*.pt")
                      if p.stem.isdigit())

    def save(self, step: int, params, opt_state=None, hiddens=None,
             cursor=None, metrics: dict | None = None):
        payload = {"params": _to_cpu(params)}
        if opt_state is not None:
            payload["opt_state"] = _to_cpu(opt_state)
        if hiddens is not None:
            payload["hiddens"] = _to_cpu(tuple(hiddens))
        if cursor is not None:
            payload["cursor"] = torch.as_tensor(
                np.asarray(cursor, np.int64))
        _atomic_write(self._path(step), lambda p: torch.save(payload, p))
        self._metrics[int(step)] = dict(metrics or {})
        self._retain()

    def _retain(self):
        steps = self.all_steps()
        self._metrics = {s: m for s, m in self._metrics.items()
                         if s in steps}
        keep = set(steps[-self.max_to_keep:]) if self.max_to_keep else set()
        best = self.best_step(strict=True)
        if best is not None:
            keep.add(best)
        for s in steps:
            if s not in keep:
                self._path(s).unlink(missing_ok=True)
                self._metrics.pop(s, None)
        _atomic_write(self.dir / _METRICS, lambda p: p.write_text(
            json.dumps({str(s): m for s, m in sorted(
                self._metrics.items())})))

    def best_step(self, strict: bool = False):
        """Step with the lowest recorded val_nll_bits (the latest of
        equals).  With no recorded val metric anywhere (e.g. the corpus had
        no held-out split): ``strict=True`` returns None so callers can
        warn; the default falls back to the latest step."""
        best, best_v = None, float("inf")
        for s in self.all_steps():
            v = (self._metrics.get(s) or {}).get("val_nll_bits")
            if v is not None and float(v) <= best_v:
                best, best_v = s, float(v)
        if best is not None:
            return best
        return None if strict else self.latest_step()

    def restore(self, step: int | None = None, template=None):
        """The checkpoint at ``step`` (default the latest) as a dict with
        "params", "opt_state", "hiddens" (a tuple), "cursor" (an int64
        numpy array) and "step"; None when there is none.  Without a
        template the tensors are on the CPU; with one, each leaf takes the
        device and dtype of the template's leaf at its place (``_place``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        restored = torch.load(self._path(step), map_location="cpu",
                              weights_only=True)
        if "cursor" in restored:
            restored["cursor"] = restored["cursor"].numpy()
        if template is not None:
            for key in ("params", "opt_state", "hiddens"):
                if key in restored and template.get(key) is not None:
                    restored[key] = _place(restored[key], template[key])
        if restored.get("hiddens") is not None:
            restored["hiddens"] = tuple(restored["hiddens"])
        restored["step"] = int(step)
        return restored

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Writes finish inside ``save``; kept for the reference's API."""

    def close(self):
        """Nothing stays open; kept for the reference's API."""

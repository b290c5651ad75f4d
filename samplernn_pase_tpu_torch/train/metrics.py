"""Structured metrics, as ``samplernn_pase_tpu.train.metrics``.

JSONL lines: {"step": N, "split": "train|val", "nll_bits": x,
"samples_per_sec": y, ...}, mirrored to stderr; the keys are the
reference's.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class MetricsWriter:
    def __init__(self, path=None, echo: bool = True):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        else:
            self._f = None
        self._t0 = time.time()

    def write(self, **kv):
        kv.setdefault("wall_s", round(time.time() - self._t0, 3))
        line = json.dumps(kv)
        if self._f:
            self._f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr)

    def close(self):
        if self._f:
            self._f.close()

"""The skip line of the port's measured entry points, as
``samplernn_pase_tpu.utils.tpu_guard.skip_marker``.

A measured entry point (``bench``, ``scripts.bench_train``) prints this
line and exits 0 when there is no CUDA device, so that a missing card is
told apart from a failing run.  The reference's tunnel probes and box
locks have no counterpart: ``torch.cuda.is_available()`` answers at once.
"""

from __future__ import annotations

import json


def skip_marker(reason: str = "cuda_unavailable") -> str:
    """The one-line JSON printed in place of a result when skipping."""
    return json.dumps({"skipped": True, "reason": reason})

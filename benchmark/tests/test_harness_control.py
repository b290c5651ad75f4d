"""The control, the reference in a lower precision put in the program's place
(float8 for the served cells' tokens, bfloat16 for the waveform's decode),
comes out as not correct through the harness's own comparison: with
``run.control`` set, each driver's check hands the control's numbers to
``execute`` in place of the program's, and ``correct`` is judged against
the limits committed for the real cells.  At a size a test run holds, on
the CPU.  The tiny training cell stands int8 in (its traffic's
``control``): at that size float8 moves the first steps' NLL by 1e-3 to
5e-3 bits, under the committed limit, which float8 passes at the real
cell's size only; there (B=128, seq_len 1024, 2 GRU layers of
1024) the same runs come from ``benchmark.control`` on the card (see
``PERF.md``)."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.tests import tiny

WIDE = dict(tiny.TINY_TTS, dim=128, embed_dim=16)
LONG = {"n": 8, "min_s": 0.3, "max_s": 1.0, "mean_s": 0.6}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # the pool cells at a width where float8 moves a token's choice, with
    # requests long enough that some thousands of tokens are compared
    cells = {name: (config, mix, dict(traffic, lengths=LONG,
                                      max_cond_frames=64, check_requests=4)
                    if traffic["driver"] in ("stream", "jobs") else traffic)
             for name, (config, mix, traffic) in tiny.CELLS.items()}
    root = tiny.scratch(tmp_path_factory.mktemp("control"), cells,
                        limit=None)
    (root / "benchmark" / "configs" / "tiny_tts.json").write_text(
        json.dumps({"name": "tiny_tts", "model": WIDE, "reduced": []}))
    return root


@pytest.mark.parametrize("seed", [23, 24])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(root, cell, seed):
    runs = []

    def patch(run):
        run.control = True
        runs.append(run)

    out = harness.execute(root, cell, seed, 0.6, False, "cpu", patch=patch)
    assert out["correct"] is False, out["checks"]
    committed = json.loads((tiny.BENCH / "limits"
                            / f"{tiny.REAL[cell.split('-')[1]]}.json")
                           .read_text())
    assert {k: c["limit"] for k, c in out["checks"].items()} == committed
    # the program's own numbers, read in the same run, pass those limits
    r = runs[0].readings
    assert all(r[k] <= c["limit"] for k, c in out["checks"].items()), r

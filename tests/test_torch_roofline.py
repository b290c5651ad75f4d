"""K8 and K9, the roofline microkernels: their plain versions (what the
wrappers run on CPU tensors) against the reference's ``vpu_tail(...,
use_prng=False, interpret=True)`` and ``mxu_stream(..., interpret=True)``
at the flagship's shapes, on the reference's own inputs, with
``scripts/vpu_ceiling.py`` loaded through importlib as
``tests/test_pallas.py`` does.  K8's samples must be equal; K9's float32
accumulator within 1e-4 of its largest value (the products are exact in
both, the sums run in another order and a bf16 rounding of the hidden
activations may land on the other side)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from samplernn_pase_tpu_torch.ops.kernels.noise import gumbel_block
from samplernn_pase_tpu_torch.scripts import vpu_ceiling as tvc


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "vpu_ceiling",
        Path(__file__).resolve().parents[1] / "scripts" / "vpu_ceiling.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.mark.parametrize("n_frames", [1, 3])
def test_vpu_tail_matches_reference(ref, n_frames):
    x = ref._inputs(np.random.default_rng(0))
    want = np.asarray(ref.vpu_tail(x["logits"], x["gum"], 7,
                                   n_frames=n_frames, use_prng=False,
                                   interpret=True))
    t = tvc.inputs("cpu")
    got, ring = tvc.vpu_tail(t["logits"], t["gum"], 7, n_frames=n_frames,
                             use_prng=False, return_ring=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # the ring holds the one-hots of the last f1 steps, at slot (t + i) % f1
    f1, q = tvc.F1, tvc.Q
    last = n_frames - 1
    for i in range(f1):
        slot = (last + i) % f1
        row = ring[:, slot * q:(slot + 1) * q].float()
        assert torch.equal(row.argmax(-1), got[:, i].long())
        assert torch.equal(row.sum(-1), torch.ones(tvc.B))


def test_mxu_stream_matches_reference(ref):
    x = ref._inputs(np.random.default_rng(0))
    names = ("ebuf", "w1", "w2", "wh", "wo", "wup")
    want = np.asarray(ref.mxu_stream(*(x[k] for k in names), n_frames=1,
                                     interpret=True))
    t = tvc.inputs("cpu")
    got = tvc.mxu_stream(*(t[k] for k in names), n_frames=1).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_vpu_tail_philox_frames_and_smoke():
    """With use_prng the noise of step i of frame t is the Philox block at
    position t*f1 + i; the script's smoke check passes on the CPU."""
    gen = torch.Generator().manual_seed(0)
    b, q, f1 = 4, 128, 4
    logits = torch.randn(b, q, generator=gen)
    gum = torch.zeros(f1, b, q)
    got = tvc.vpu_tail(logits, gum, 9, n_frames=3, use_prng=True)
    g = gumbel_block(9, b, 2 * f1, f1, q)
    want = torch.argmax(logits + tvc.TEMPERATURE * g, -1).T
    assert torch.equal(got.long(), want)
    assert tvc.smoke() == 0
    assert set(tvc.LAUNCHES.values()) == {0}

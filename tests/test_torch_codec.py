"""K7, the mu-law codec kernels: their plain versions (what the wrappers
run on CPU tensors) against the JAX package's Pallas codec in interpret
mode, at the reference's own bar (``tests/test_pallas.py``: levels at
most 1 apart, on under 1e-3 of the inputs; decode within 1e-6), and
against ``samplernn_pase_tpu.ops.mulaw``: encode bit-exact at every
level, its midpoints and one ulp either side, decode within 3 ulp
(ROADMAP.md C)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from samplernn_pase_tpu.ops import mulaw as jmulaw
from samplernn_pase_tpu.ops.pallas import codec as pcodec
from samplernn_pase_tpu_torch import generate as tgen
from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.ops import mulaw as tmulaw
from samplernn_pase_tpu_torch.ops.kernels import codec as kcodec


@pytest.mark.parametrize("q_levels", [256, 1024])
def test_codec_matches_pallas_codec(q_levels):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, (8, 4096)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_e = np.asarray(pcodec.mu_law_encode_fused(jnp.asarray(x),
                                                       q_levels))
        got_e = kcodec.mu_law_encode(torch.from_numpy(x), q_levels).numpy()
        assert got_e.dtype == np.int32 and got_e.shape == x.shape
        diff = got_e != want_e
        assert diff.mean() < 1e-3 and np.abs(got_e - want_e).max() <= 1
        want_d = np.asarray(pcodec.mu_law_decode_fused(jnp.asarray(got_e),
                                                       q_levels))
    got_d = kcodec.mu_law_decode(torch.from_numpy(got_e), q_levels).numpy()
    assert got_d.dtype == np.float32
    np.testing.assert_allclose(got_d, want_d, atol=1e-6)


def test_codec_against_reference_at_every_level():
    lv = np.arange(256, dtype=np.int32)
    points = np.asarray(jmulaw.mu_law_decode(jnp.asarray(lv)))
    mid = ((points[1:].astype(np.float64) + points[:-1]) / 2).astype(
        np.float32)
    x = np.concatenate([points, mid, np.nextafter(mid, np.float32(2)),
                        np.nextafter(mid, np.float32(-2))])
    got = kcodec.mu_law_encode(torch.from_numpy(x[None])).numpy()
    np.testing.assert_array_equal(
        got.reshape(-1), np.asarray(jmulaw.mu_law_encode(x)))
    dec = kcodec.mu_law_decode(torch.from_numpy(lv.reshape(2, 128)))
    np.testing.assert_array_max_ulp(dec.numpy().reshape(-1), points,
                                    maxulp=3)
    np.testing.assert_array_equal(
        kcodec.mu_law_encode(dec).numpy().reshape(-1), lv)


def test_wrappers_on_cpu_and_decode_waveform():
    """On CPU tensors the wrappers are ops/mulaw.py's functions (rows may
    be strided) and launch nothing; decode_waveform takes them for the
    mu-law codec and keeps the linear codec plain."""
    kcodec.reset_launches()
    buf = torch.randint(0, 256, (3, 40), dtype=torch.int32)
    view = buf[:, 8:]
    torch.testing.assert_close(kcodec.mu_law_decode(view),
                               tmulaw.mu_law_decode(view), rtol=0, atol=0)
    wave = torch.linspace(-1.5, 1.5, 96).reshape(3, 32)
    torch.testing.assert_close(kcodec.mu_law_encode(wave, 64),
                               tmulaw.mu_law_encode(wave, 64), rtol=0, atol=0)
    assert set(kcodec.LAUNCHES.values()) == {0}
    cfg = SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8)
    torch.testing.assert_close(tgen.decode_waveform(view, cfg),
                               tmulaw.mu_law_decode(view), rtol=0, atol=0)
    torch.testing.assert_close(tgen.decode_waveform(view[0], cfg),
                               tmulaw.mu_law_decode(view[0]), rtol=0, atol=0)
    lin = SampleRNNConfig(frame_sizes=(4, 2), dim=16, embed_dim=8,
                          codec="linear")
    torch.testing.assert_close(tgen.decode_waveform(view, lin),
                               tmulaw.linear_dequantize(view), rtol=0,
                               atol=0)


@pytest.mark.parametrize("q_levels", [256, 1024])
def test_plain_decode_of_levels_outside_the_range(q_levels):
    """Levels no encode makes still get a value from the plain decode (K7
    takes the formula for them): within 3 ulp of the reference's, and the
    same infinity where the reference's overflows."""
    lv = np.array([-2 ** 31, -1, q_levels, q_levels + 7, 2 ** 31 - 1],
                  np.int32)
    want = np.asarray(jmulaw.mu_law_decode(jnp.asarray(lv), q_levels))
    got = kcodec.mu_law_decode(torch.from_numpy(lv[None]),
                               q_levels).numpy()[0]
    inf = np.isinf(want)
    assert inf.any() and (np.isinf(got) == inf).all()
    np.testing.assert_array_equal(got[inf], want[inf])
    np.testing.assert_array_max_ulp(got[~inf], want[~inf], maxulp=3)


@pytest.mark.parametrize("q_levels", [256, 1024])
def test_plain_encode_of_edge_values(q_levels):
    """Signed zeros, +-1, infinities, subnormals and |x| > 1 encode to the
    reference's levels exactly."""
    tiny = np.finfo(np.float32).tiny
    sub = np.array([tiny / 2, tiny / 3, np.float32(1e-45), tiny * 0.999],
                   np.float32)
    x = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1.0000001,
                  -1.0000001, 1.5, -7.0, 3e38, -3e38], np.float32),
        sub, -sub]).astype(np.float32)
    want = np.asarray(jmulaw.mu_law_encode(jnp.asarray(x), q_levels))
    got = kcodec.mu_law_encode(torch.from_numpy(x[None]), q_levels).numpy()
    np.testing.assert_array_equal(got[0], want)

"""The port's PASE encoder and extraction against the JAX package's, on the
CPU in float32, from the same parameters (``convert.pase_from_jax``) and
the same numpy inputs from a seed.  Tolerances: ``sinc_filters`` 1e-6;
conv outputs and embeddings 2e-4 (the reference's own conv-oracle bar,
tests/test_pase.py); BatchNorm running mean and variance 1e-6, ``count``
equal; checkpoint files read to equal trees in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import extract as jext
from samplernn_pase_tpu.config import PASEConfig as JPase
from samplernn_pase_tpu.models import pase as jpase
from samplernn_pase_tpu.ops.audio_io import write_wav
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch import extract as text
from samplernn_pase_tpu_torch.config import PASEConfig as TPase
from samplernn_pase_tpu_torch.models import pase as tpase
from samplernn_pase_tpu_torch.tree import tree_leaves

TINY = dict(sinc_filters=8, sinc_kernel=65,
            blocks=((8, 10, 4), (16, 5, 2), (16, 5, 2)),
            emb_dim=12, compute_dtype="float32")
TOL = 2e-4


def _pair(seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, JAX bn, port params, port bn), the
    running statistics moved off their init so eval mode reads them."""
    jc, tc = JPase(**{**TINY, **kw}), TPase(**{**TINY, **kw})
    jp, jb = jax.device_get(jpase.init_pase(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for st in [jb["sinc"], *jb["blocks"], jb["proj"]]:
        st["mean"] = rng.normal(size=st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    tp, tb = convert.pase_from_jax(jp, jb)
    return jc, tc, jp, jb, tp, tb


def _close(port_tree, jax_tree, atol):
    """Leaf by leaf, matched by key and index (JAX flattens dicts in sorted
    key order, the port in insertion order)."""
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(jax_tree)
        for k in port_tree:
            _close(port_tree[k], jax_tree[k], atol)
    elif isinstance(port_tree, (list, tuple)):
        assert len(port_tree) == len(jax_tree)
        for a, b in zip(port_tree, jax_tree):
            _close(a, b, atol)
    else:
        assert tuple(port_tree.shape) == np.shape(jax_tree)
        np.testing.assert_allclose(port_tree.detach().numpy(),
                                   np.asarray(jax_tree), atol=atol, rtol=0)


def _sinc_f64(p, cfg):
    """The filter bank from the same float32 sine arguments, the rest in
    float64: what both packages' float32 banks approximate."""
    k, sr = cfg.sinc_kernel, cfg.sample_rate
    half = (k - 1) // 2
    f32 = np.float32
    low = f32(cfg.min_low_hz) + np.abs(p["low_hz"])
    high = np.minimum(f32(sr / 2), np.maximum(
        f32(cfg.min_low_hz), low + f32(cfg.min_band_hz)
        + np.abs(p["band_hz"])))
    n = np.arange(1, half + 1, dtype=f32) / f32(sr)
    ft = (f32(2 * np.pi) * n)[None]
    arg_h = (high[:, None] * ft).astype(np.float64)
    arg_l = (low[:, None] * ft).astype(np.float64)
    right = (np.sin(arg_h) - np.sin(arg_l)) / (np.pi * n.astype(np.float64))
    bw = (high - low).astype(np.float64)[:, None]
    filt = np.concatenate([right[:, ::-1], 2 * bw, right], axis=1)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(k) / (k - 1))
    return filt * window[None] / (2 * bw)


@pytest.mark.parametrize("which", ["tiny", "config3"])
def test_sinc_init_and_filters_match(which):
    """Init cutoffs equal; banks within 1e-6 of the reference's at the tiny
    config.  At config 3's 64 x 251 bank the two float32 banks part by up
    to 1.13e-6 where sin(h t) - sin(l t) cancels (near the centre of the
    narrow low filters: two sines, each within an ulp, subtracted), so
    there each bank is held within 1e-6 of the float64 evaluation of the
    same float32 arguments (the reference's own distance is 9.2e-7) and the
    two within 2e-6 of each other."""
    kw = {} if which == "config3" else TINY
    jc, tc = JPase(**kw), TPase(**kw)
    jp = jax.device_get(jpase.init_sinc(jax.random.PRNGKey(0), jc))
    tp = tpase.init_sinc(tc)
    _close(tp, jp, 0)
    rng = np.random.default_rng(1)
    for p in (jp, {k: (v + rng.normal(size=v.shape) * 30).astype(np.float32)
                   for k, v in jp.items()}):
        # the init (its top filter's high at the clip) and cutoffs moved
        # off it (some across the clip)
        got = tpase.sinc_filters(convert.params_from_jax(p), tc).numpy()
        want = np.asarray(jpase.sinc_filters(p, jc))
        assert got.shape == want.shape == (tc.sinc_filters, tc.sinc_kernel)
        if which == "tiny":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        else:
            exact = _sinc_f64(p, tc)
            np.testing.assert_allclose(want, exact, atol=1e-6, rtol=0)
            np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)
            np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# (c_in, c_out, kernel, stride, T): odd and even kernels at strides 1, 2
# and 10, lengths that leave SAME an odd pad (asymmetric) and an even one
BLOCKS = [(3, 5, 5, 1, 33), (3, 5, 4, 1, 32), (4, 6, 5, 2, 32),
          (4, 6, 4, 2, 31), (2, 4, 20, 10, 100), (2, 4, 11, 10, 95)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", BLOCKS, ids=lambda s: "k{}s{}t{}".format(
    *s[2:]))
def test_conv_block_matches_reference(shape, train):
    c_in, c_out, k, stride, t = shape
    rng = np.random.default_rng(k * 100 + stride)
    p = {"w": rng.normal(size=(c_out, c_in, k)).astype(np.float32) * 0.3,
         "alpha": rng.uniform(0.1, 0.4, c_out).astype(np.float32),
         "bn_scale": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
         "bn_bias": rng.normal(size=c_out).astype(np.float32)}
    st = {"mean": rng.normal(size=c_out).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, c_out).astype(np.float32),
          "count": np.asarray(3.0, np.float32)}
    x = rng.normal(size=(3, c_in, t)).astype(np.float32)
    want, wst = jpase.conv_block_apply(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, st),
        jnp.asarray(x), stride, train=train, compute_dtype=jnp.float32)
    tp, tst = convert.pase_from_jax(p, st)
    got, gst = tpase.conv_block_apply(tp, tst, torch.from_numpy(x), stride,
                                      train=train, compute_dtype="float32")
    assert got.shape == want.shape == (3, c_out, -(-t // stride))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for key in ("mean", "var"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   atol=1e-6, rtol=0)
        assert not gst[key].requires_grad
    assert float(gst["count"]) == float(wst["count"]) == 3.0 + train


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pase_apply_matches_reference(train):
    jc, tc, jp, jb, tp, tb = _pair(2)
    wav = (np.random.default_rng(3).normal(size=(2, 512)) * 0.3).astype(
        np.float32)
    want, wst = jpase.pase_apply(jax.tree.map(jnp.asarray, jp),
                                 jax.tree.map(jnp.asarray, jb),
                                 jnp.asarray(wav), jc, train=train)
    got, gst = tpase.pase_apply(tp, tb, torch.from_numpy(wav), tc,
                                train=train)
    assert got.shape == want.shape == (2, 512 // 16, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    _close(gst, wst, 1e-6)
    if not train:   # eval mode hands the running state back untouched
        assert gst["sinc"] is tb["sinc"] and gst["proj"] is tb["proj"]
        assert all(a is b for a, b in zip(gst["blocks"], tb["blocks"]))


def test_init_pase_tree_matches_reference_layout():
    jc, tc = JPase(**TINY), TPase(**TINY)
    jp, jb = jax.device_get(jpase.init_pase(jax.random.PRNGKey(0), jc))
    tp, tb = tpase.init_pase(torch.Generator().manual_seed(0), tc, "cpu")
    for port, ref in ((tp, jp), (tb, jb)):
        # same keys and shapes (values differ: another generator)
        _close(jax.tree.map(lambda t: torch.zeros_like(t), port),
               jax.tree.map(np.zeros_like, ref), 0)
        assert all(a.dtype == torch.float32 for a in tree_leaves(port))
    assert tb["proj"]["count"].shape == ()


def _legacy(jp, jb):
    """A legacy pair: conv biases d and running means tracked on conv + d
    (the same eval function as the clean pair)."""
    lp = dict(jp, blocks=[dict(b, b=np.full(b["w"].shape[0], 0.5,
                                            np.float32))
                          for b in jp["blocks"]],
              proj=dict(jp["proj"], b=np.full(jp["proj"]["w"].shape[0],
                                              0.25, np.float32)))
    lb = dict(jb, blocks=[dict(s, mean=s["mean"] + 0.5)
                          for s in jb["blocks"]],
              proj=dict(jb["proj"], mean=jb["proj"]["mean"] + 0.25))
    return lp, lb


def test_absorb_legacy_bias_matches_reference():
    jc, tc, jp, jb, tp, tb = _pair(4)
    lp, lb = _legacy(jp, jb)
    wp, wb, wchanged = jpase.absorb_legacy_bias(lp, lb)
    gp, gb, gchanged = tpase.absorb_legacy_bias(*convert.pase_from_jax(lp,
                                                                      lb))
    assert gchanged and wchanged
    _close(gp, jax.device_get(wp), 0)
    _close(gb, jax.device_get(wb), 0)
    wav = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 256)).astype(np.float32))
    np.testing.assert_allclose(
        tpase.pase_apply(gp, gb, wav, tc)[0].numpy(),
        tpase.pase_apply(tp, tb, wav, tc)[0].numpy(), atol=1e-5)
    assert tpase.absorb_legacy_bias(tp, tb)[2] is False


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_files_both_directions(tmp_path, direction):
    """A file written by one package's export reads in the other's import
    to the same trees (a legacy tree exports its folded form); a conv bias
    in the file folds into the running mean the same way in both."""
    jc, tc, jp, jb, tp, tb = _pair(6)
    lp, lb = _legacy(jp, jb)
    path = tmp_path / "pase.pt"
    if direction == "ref_to_port":
        jpase.export_torch_pase(lp, lb, path)
    else:
        tpase.export_torch_pase(*convert.pase_from_jax(lp, lb), path)
    gp, gb, grep = tpase.load_torch_pase(path, tc)
    wp, wb, wrep = jpase.load_torch_pase(path, jc)
    assert grep == wrep and not grep["skipped"] and not grep[
        "missing_blocks"]
    _close(gp, jax.device_get(wp), 0)
    _close(gb, jax.device_get(wb), 0)
    # the round trip keeps the clean pair's function exactly
    _close(gp, jp, 0)
    _close({k: v for k, v in gb.items() if k != "blocks"},
           {k: v for k, v in jb.items() if k != "blocks"}, 1e-6)
    # a nonzero conv bias in the file, folded by both importers
    sd = torch.load(path, weights_only=True)
    sd["blocks.2.conv.bias"] = torch.full((16,), 0.75)
    sd["proj.conv.bias"] = torch.full((12,), -0.5)
    torch.save(sd, path)
    gp, gb, _ = tpase.load_torch_pase(path, tc)
    wp, wb, _ = jpase.load_torch_pase(path, jc)
    _close(gb, jax.device_get(wb), 0)


def test_load_strict_errors_match_reference(tmp_path):
    jc, tc, jp, jb, tp, tb = _pair(7)
    sd = tpase.export_torch_pase(tp, tb)
    cases = {
        "zero": ({"unrelated.weight": torch.zeros(3)}, "loaded ZERO"),
        "missing": ({k: v for k, v in sd.items()
                     if k != "blocks.2.conv.weight"}, r"conv blocks \[1\]"),
        "shape": ({**sd, "blocks.1.conv.weight": torch.zeros(8, 8, 3)},
                  "has shape"),
    }
    for name, (state, match) in cases.items():
        path = tmp_path / f"{name}.pt"
        torch.save(state, path)
        for load, cfg in ((tpase.load_torch_pase, tc),
                          (jpase.load_torch_pase, jc)):
            with pytest.raises(ValueError, match=match):
                load(path, cfg)
    # strict=False proceeds and reports the same layout as the reference
    path = tmp_path / "missing.pt"
    _, _, grep = tpase.load_torch_pase(path, tc, strict=False)
    _, _, wrep = jpase.load_torch_pase(path, jc, strict=False)
    assert grep == wrep and grep["missing_blocks"] == [1]


LENGTHS = (300, 512, 1000, 64)


def test_extract_embeddings_matches_reference():
    jc, tc, jp, jb, tp, tb = _pair(8)
    rng = np.random.default_rng(2)
    wavs = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in LENGTHS]
    want = jext.extract_embeddings(jax.tree.map(jnp.asarray, jp),
                                   jax.tree.map(jnp.asarray, jb), jc, wavs,
                                   batch_size=2)
    got = text.extract_embeddings(tp, tb, tc, wavs, batch_size=2,
                                  device="cpu")
    for n, g, w in zip(LENGTHS, got, want):
        assert g.shape == w.shape == (max(n // 16, 1), 12)
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=TOL)


def test_extract_to_dir_matches_reference(tmp_path):
    """A speaker tree with a duplicate stem and a 22.05 kHz wav: the same
    files, mirrored, with the same arrays."""
    jc, tc, jp, jb, tp, tb = _pair(9)
    rng = np.random.default_rng(3)
    wav_dir = tmp_path / "wavs"
    for i, (spk, sr) in enumerate((("a", 16_000), ("b", 16_000),
                                   ("b", 22_050))):
        (wav_dir / spk).mkdir(parents=True, exist_ok=True)
        write_wav(wav_dir / spk / f"u{i % 2}.wav",
                  rng.uniform(-0.5, 0.5, 400 + 100 * i), sr)
    want = jext.extract_to_dir(jax.tree.map(jnp.asarray, jp),
                               jax.tree.map(jnp.asarray, jb), jc, wav_dir,
                               tmp_path / "j", batch_size=2)
    got = text.extract_to_dir(tp, tb, tc, wav_dir, tmp_path / "t",
                              batch_size=2, device="cpu")
    assert [p.relative_to(tmp_path / "t") for p in got] == \
        [p.relative_to(tmp_path / "j") for p in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.load(g), np.load(w), atol=TOL)
    with pytest.raises(FileNotFoundError):
        text.extract_to_dir(tp, tb, tc, tmp_path / "empty_in",
                            tmp_path / "x", device="cpu")

"""The port's configs, codecs, weight norm and converter against the JAX
package (samplernn_pase_tpu is the reference)."""

import ast
import dataclasses
import glob
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu import config as jcfg
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.ops import mulaw as jmulaw
from samplernn_pase_tpu.ops import weight_norm as jwn
from samplernn_pase_tpu_torch import config as tcfg
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch.ops import mulaw as tmulaw
from samplernn_pase_tpu_torch.ops import weight_norm as twn

ROOT = Path(__file__).resolve().parents[1]
CLASSES = ("SampleRNNConfig", "PASEConfig", "TrainConfig", "GenerateConfig",
           "ExperimentConfig")


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return dataclasses.asdict(f.default_factory())
    return dataclasses.MISSING


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.type == b.type, a.name
        assert _default(a) == _default(b), a.name
    assert jc.__dataclass_params__.frozen == tc.__dataclass_params__.frozen


def test_properties_match():
    for fs in ((16, 4), (16, 4, 4), (4, 2), (4, 2, 2), (8,)):
        j = jcfg.SampleRNNConfig(frame_sizes=list(fs), dim=16)
        t = tcfg.SampleRNNConfig(frame_sizes=list(fs), dim=16)
        assert (j.lookback, j.n_tiers, j.tier_spans, j.frame_sizes) == \
            (t.lookback, t.n_tiers, t.tier_spans, t.frame_sizes)
    assert jcfg.PASEConfig().decimation == tcfg.PASEConfig().decimation
    with pytest.raises(ValueError):
        tcfg.SampleRNNConfig(dim=64, mlp_hidden=32)


@pytest.mark.parametrize("name", jcfg.PRESETS)
def test_presets_match(name):
    assert jcfg.PRESETS == tcfg.PRESETS
    assert jcfg.to_json(jcfg.preset(name)) == tcfg.to_json(tcfg.preset(name))
    with pytest.raises(KeyError):
        tcfg.preset("no_such_preset")


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "configs/*.json"))))
def test_config_files_load_identically(path):
    j, t = jcfg.load_config(path), tcfg.load_config(path)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert json.loads(tcfg.to_json(t)) == json.loads(jcfg.to_json(j))
    assert tcfg.from_json(tcfg.to_json(t)) == t


def test_mulaw_encode_bit_exact_all_levels_and_boundaries():
    lv = np.arange(256, dtype=np.int32)
    points = np.asarray(jmulaw.mu_law_decode(jnp.asarray(lv)))
    mid = ((points[1:].astype(np.float64) + points[:-1]) / 2).astype(
        np.float32)
    x = np.concatenate([
        points, mid, np.nextafter(mid, np.float32(2)),
        np.nextafter(mid, np.float32(-2)),
        np.linspace(-1.2, 1.2, 100_001, dtype=np.float32),
        np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0], np.float32)])
    got = tmulaw.mu_law_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmulaw.mu_law_encode(x)))
    np.testing.assert_array_equal(
        tmulaw.mu_law_encode(tmulaw.mu_law_decode(torch.from_numpy(lv))), lv)
    got = tmulaw.linear_quantize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmulaw.linear_quantize(x)))
    assert tmulaw.quantize_zero(256) == jmulaw.quantize_zero(256) == 128


def test_mulaw_decode_all_levels():
    """Decode: bit-exact with float32 arithmetic around a correctly rounded
    expm1.  XLA's CPU expm1 is 1 ulp off at 48 of the 256 levels, which the
    division by mu turns into at most 3 ulp of the result (ROADMAP.md C)."""
    lv = np.arange(256, dtype=np.int32)
    got = tmulaw.mu_law_decode(torch.from_numpy(lv)).numpy()
    ref = np.asarray(jmulaw.mu_law_decode(jnp.asarray(lv)))
    np.testing.assert_array_max_ulp(got, ref, maxulp=3)
    mu = np.float32(255)
    y = (np.float32(2) * (lv.astype(np.float32) / mu) - np.float32(1))
    a = np.abs(y) * np.log1p(mu)
    want = (np.sign(y) * np.expm1(a.astype(np.float64)).astype(np.float32)
            / mu)
    np.testing.assert_array_equal(got, want)
    for fn in ("linear_dequantize", "levels_to_float"):
        np.testing.assert_array_equal(
            getattr(tmulaw, fn)(torch.from_numpy(lv)).numpy(),
            np.asarray(getattr(jmulaw, fn)(jnp.asarray(lv))))


def test_weight_norm_resolve_matches():
    rng = np.random.default_rng(0)
    for shape in ((7, 5), (3, 4, 6)):
        w = rng.normal(size=shape).astype(np.float32)
        jw = jwn.make(jnp.asarray(w))
        tw = twn.make(torch.from_numpy(w))
        np.testing.assert_allclose(tw["g"].numpy(), np.asarray(jw["g"]),
                                   rtol=1e-6)
        scaled = {"v": jw["v"], "g": jw["g"] * 1.5}
        t_scaled = convert.params_from_jax(jax.device_get(scaled))
        np.testing.assert_allclose(twn.resolve(t_scaled).numpy(),
                                   np.asarray(jwn.resolve(scaled)),
                                   atol=1e-6)
    plain = torch.ones(3)
    assert twn.resolve(plain) is plain


@pytest.mark.parametrize("weight_norm", [False, True])
def test_params_from_jax_round_trips(weight_norm):
    cfg = jcfg.SampleRNNConfig(frame_sizes=(4, 2, 2), dim=16, embed_dim=8,
                               weight_norm=weight_norm)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(0), cfg))
    tp = convert.params_from_jax(jp)
    assert isinstance(tp["tiers"][0]["rnn"][0]["w_ih"], torch.Tensor)
    back = convert.to_numpy(tp)
    flat_j, tree_j = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)
    js = jax.device_get(jsrnn.initial_state(jp, cfg, 3))
    ts = convert.state_from_jax(js)
    assert isinstance(ts, tuple) and len(ts) == 3
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b.numpy())


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the JAX package may be loaded, and nothing outside torch, numpy
    and the standard library (scipy in particular: the port reads, writes
    and resamples audio without it)."""
    pkg = ROOT / "samplernn_pase_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py"))
    assert "samplernn_pase_tpu_torch.generate" in mods
    code = ("import importlib, sys\n"
            "import numpy, torch\n"
            "base = {m.split('.')[0] for m in sys.modules}\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'samplernn_pase_tpu.')) or m == 'samplernn_pase_tpu']\n"
            "added = sorted({m.split('.')[0] for m in sys.modules} - base)\n"
            "print(bad)\n"
            "print(added)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # beyond what importing torch and numpy loads, the port loads only
    # itself and the standard library (no scipy: audio_io reads, writes
    # and resamples without it)
    added = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    assert "samplernn_pase_tpu_torch.ops.audio_io" in mods
    assert "samplernn_pase_tpu_torch" in added
    foreign = [r for r in added if r != "samplernn_pase_tpu_torch"
               and r not in sys.stdlib_module_names]
    assert not foreign, foreign
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    roots = {n.split(".")[0] for n in names}
    assert "samplernn_pase_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "samplernn_pase_tpu"}, roots

"""The split plan of the skinny wgmma core (``decode.gemm_plan``) that K2's
bf16 route and K9 run on: checked on the CPU, since the kernel that takes
it runs only on the card.

The plan is a pure function of K, N and the weight type, never of M (a
B=1 stream and a lane of a B=128 pool must add the same partials in the
same order); its K-slices are 16-row multiples that tile K in rank order;
the cluster is a portable size (<= 8); a CTA's shared memory fits the
H100's 227 KB; every product of the main paths with K, N >= 1024 runs on
at least 64 CTAs, no more than the card holds at once (clusters of 4 and
8: 120 CTAs, measured), so that no product takes a second wave; a
smaller product takes the largest split its K allows (slices of at least
256 rows) that the card holds at once."""

import inspect

import pytest
import torch

from samplernn_pase_tpu_torch.config import SampleRNNConfig, preset
from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
from samplernn_pase_tpu_torch.scripts import vpu_ceiling as tvc


def _models():
    flagship = SampleRNNConfig(frame_sizes=(16, 4), dim=1024, embed_dim=256,
                               q_levels=256, compute_dtype="bfloat16")
    stacked = preset("c5_gen_b128").model
    return {"flagship": flagship,
            "stacked": SampleRNNConfig(**{**stacked.__dict__, "n_rnn": 2}),
            "c2": preset("c2_3tier_lstm").model,
            "c4": preset("c4_tts_conditioned").model}


def _products():
    """Every distinct bf16 product (K, N) of the four main paths' decode
    (as chip_smoke.k2_cases lists them: tier input, gate products,
    upsample; config 4's conditioning projection) and of K9's stream."""
    out = set()
    for cfg in _models().values():
        gates = 4 if cfg.rnn_type == "lstm" else 3
        for k, span in enumerate(cfg.tier_spans):
            out |= {(span, cfg.dim), (cfg.dim, gates * cfg.dim),
                    (cfg.dim, cfg.frame_sizes[k] * cfg.dim)}
        if cfg.cond_dim:
            out.add((cfg.cond_dim, cfg.dim))
    h, q, f1 = tvc.H, tvc.Q, tvc.F1
    out |= {(h, f1 * h), (f1 * q, h), (h, h), (h, q)}
    return sorted(out)


PRODUCTS = _products()
# the main paths' products and the shapes the GPU tests sweep
SHAPES = sorted(set(PRODUCTS) | {(k, n) for k in (4, 16, 64, 200, 256, 1024,
                                                  4096)
                                 for n in (70, 256, 1000, 1024, 3072, 16384)})


def _allowed_split(k: int) -> int:
    """The largest portable split whose slices are all at least 256 rows
    deep, or 1."""
    k_pad = -(-k // 16) * 16
    return max(s for s in (1, 2, 4, 8) if s == 1 or 256 * s <= k_pad)


def test_plan_takes_no_m():
    assert list(inspect.signature(kdec.gemm_plan).parameters) == [
        "k", "n", "w_dtype"]
    assert kdec.gemm_plan(1024, 3072) == kdec.gemm_plan(1024, 3072,
                                                        torch.bfloat16)
    assert kdec.gemm_plan(1024, 3072, torch.float32) is None


@pytest.mark.parametrize("k,n", SHAPES)
def test_plan_slices_tile_k_in_order(k, n):
    plan = kdec.gemm_plan(k, n)
    slices = kdec.k_slices(k, plan.split)
    assert len(slices) == plan.split
    assert slices[0][0] == 0 and slices[-1][1] == -(-k // 16) * 16
    for (s0, e0), (s1, _) in zip(slices, slices[1:]):
        assert e0 == s1
    for s, e in slices:
        assert s % 16 == 0 and e % 16 == 0 and e > s


@pytest.mark.parametrize("k,n", SHAPES)
def test_plan_fits_the_card(k, n):
    plan = kdec.gemm_plan(k, n)
    assert plan.split in (1, 2, 4, 8)
    assert plan.bn in kdec.STAGES
    tiles = -(-n // plan.bn)
    assert 1 <= plan.groups <= tiles
    assert plan.ctas == plan.split * plan.groups
    assert plan.smem == kdec._plan_smem(plan.bn) <= 227 * 1024


@pytest.mark.parametrize("k,n", [p for p in PRODUCTS
                                 if p[0] >= 1024 and p[1] >= 1024])
def test_large_products_fill_the_card(k, n):
    plan = kdec.gemm_plan(k, n)
    assert 64 <= plan.ctas <= kdec._resident(plan.split)


@pytest.mark.parametrize("k,n", [p for p in SHAPES
                                 if p[0] < 1024 or p[1] < 1024])
def test_small_products_take_the_largest_split(k, n):
    plan = kdec.gemm_plan(k, n)
    tiles = -(-n // plan.bn)
    assert plan.groups == tiles
    resident = [s for s in (1, 2, 4, 8) if s == 1 or (
        s <= _allowed_split(k) and s * tiles <= kdec._resident(s))]
    assert plan.split == max(resident)


def test_main_paths_products_listed():
    """The flagship's products, and K9's head-and-tail product, are among
    those checked above."""
    assert {(16, 1024), (64, 1024), (1024, 3072), (1024, 4096),
            (1024, 16384), (256, 1024), (4096, 1024)} <= set(PRODUCTS)

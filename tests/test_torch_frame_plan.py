"""K1's plan (``decode.frame_plan``), checked on the CPU, since the kernels
that take it run only on the card.

The plan is a pure function of the widths, f1 and the weight type, never
of the batch (a pool lane must be bit-equal to its solo B=1 stream); a
block's shared memory fits the H100's 227 KB; the blocks of a tile
compute every column of W_h, and every column and row of W_out, exactly
once; float32 weights take the CUDA-core kernel; every width the
CUDA-core kernel takes (dim and q_levels multiples of 64) has a route, the
main paths' widths (dim 1024, q_levels 256) the tensor-core kernel and every
other bf16 width the CUDA-core one, and anything else raises ValueError
with the reason."""

import inspect

import pytest
import torch

from samplernn_pase_tpu_torch.config import preset
from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

HDIMS = (64, 128, 1024)
QS = (64, 256)
F1S = (1, 2, 4, 8, 16)
DTYPES = (torch.bfloat16, torch.float32)
CASES = [(h, q, f1, dt) for h in HDIMS for q in QS for f1 in F1S
         for dt in DTYPES]
H100_SMEM = 232448          # bytes of shared memory a block can use


def _id(case):
    h, q, f1, dt = case
    return f"h{h}-q{q}-f{f1}-{str(dt).split('.')[-1]}"


def test_plan_takes_no_batch():
    assert list(inspect.signature(kdec.frame_plan).parameters) == [
        "hdim", "q", "f1", "w_dtype"]
    assert kdec.frame_plan(1024, 256, 16) == kdec.frame_plan(
        1024, 256, 16, torch.bfloat16)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_is_deterministic_and_fits(case):
    h, q, f1, dt = case
    plan = kdec.frame_plan(h, q, f1, dt)
    assert plan == kdec.frame_plan(h, q, f1, dt)
    assert plan.smem <= kdec.K1_SMEM_MAX <= H100_SMEM
    if plan.route == "tc":
        assert (plan.cluster, plan.lanes, plan.cols) == kdec.K1_TC
        assert (h, q) == kdec.K1_TC_WIDTHS
        assert kdec.K1_MIN_STAGES <= plan.stages <= kdec.K1_MAX_STAGES
        assert kdec.tc_box_order(plan.stages) is not None
    else:
        assert (plan.cluster, plan.lanes) == (kdec.FMA_CLUSTER,
                                              kdec.FMA_LANES)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_columns_cover_each_column_once(case):
    h, q, f1, dt = case
    plan = kdec.frame_plan(h, q, f1, dt)
    blocks = kdec.frame_columns(plan, h, q)
    assert len(blocks) == plan.cluster
    w_h = torch.zeros(h, dtype=torch.int32)
    w_out = torch.zeros(h, q, dtype=torch.int32)
    for (c0, c1), ((o0, o1), (k0, k1)) in blocks:
        assert c1 - c0 == plan.cols
        w_h[c0:c1] += 1
        w_out[k0:k1, o0:o1] += 1
    assert torch.equal(w_h, torch.ones_like(w_h))
    assert torch.equal(w_out, torch.ones_like(w_out))


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == torch.float32],
                         ids=_id)
def test_float32_takes_the_cuda_core_kernel(case):
    h, q, f1, dt = case
    assert kdec.frame_plan(h, q, f1, dt).route == "fma"


@pytest.mark.parametrize("hdim", [64 * k for k in range(1, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_width_the_cuda_core_kernel_took_has_a_route(hdim, dtype):
    for q in (64, 128, 256, 512):
        for f1 in (1, 4, 16):
            plan = kdec.frame_plan(hdim, q, f1, dtype)
            assert plan.route in ("tc", "fma")


def test_main_paths_take_the_tc_kernel():
    """Every preset that generates (the flagship's widths: dim 1024,
    q_levels 256, f1 16) runs K1 on tensor cores, on the portable 8-block
    clusters, 16 lanes a tile."""
    for name in ("c2_3tier_lstm", "c4_tts_conditioned", "c5_gen_b128"):
        m = preset(name).model
        plan = kdec.frame_plan(m.dim, m.q_levels, m.frame_sizes[0],
                               torch.bfloat16)
        assert plan.route == "tc", name
        assert (plan.cluster, plan.lanes, plan.cols) == (8, 16, 128), name


def test_tc_plan_keeps_eight_ring_slots():
    """At the presets' widths and f1 16 the tensor-core plan keeps at least
    the 8 ring slots its weight stream needs, as many as fit, and its
    shared memory is ``tcd::smem_bytes``: h1, h2, the argmax partials, the
    noise, layer 2's K-half sums (8 warps x 32 threads x 8 float32), the
    window and the ring, within ``K1_SMEM_MAX``; layer 3's out_split
    partials fit in h1's space."""
    hdim, q = kdec.K1_TC_WIDTHS
    plan = kdec.frame_plan(hdim, q, 16, torch.bfloat16)
    assert plan.route == "tc"
    assert 8 <= plan.stages <= kdec.K1_MAX_STAGES
    lanes = plan.lanes
    fixed = (1024 + 2 * lanes * hdim * 2 + (q // 64) * lanes * 8
             + 2 * lanes * 64 * 4 + 8 * 32 * 8 * 4 + lanes * 16 * 2)
    assert plan.smem == fixed + plan.stages * kdec.BOX <= kdec.K1_SMEM_MAX
    assert plan.smem + kdec.BOX > kdec.K1_SMEM_MAX   # no slot left unused
    assert 2 * plan.out_split * lanes * 64 * 4 <= lanes * hdim * 2


@pytest.mark.parametrize("stages", range(kdec.K1_MIN_STAGES,
                                         kdec.K1_MAX_STAGES + 1))
def test_tc_box_order_never_leaves_a_slot_a_phase_behind(stages):
    """Layer 2's ring order (``tcd::box_order``) for every depth the kernel
    takes: each group (K-half, tile) gets its 4 boxes in K order, and the
    box before each box in its slot (x - stages) is the same group's, so
    the warps that wait for a box by its slot's parity read the box
    before it themselves."""
    order = kdec.tc_box_order(stages)
    assert sorted(order) == list(range(16))
    for g in range(4):
        xs = [x for x in range(16) if order[x] // 4 == g]
        assert [order[x] % 4 for x in xs] == [0, 1, 2, 3]
    for x in range(stages, 16):
        assert order[x] // 4 == order[x - stages] // 4
    # positions before a step's first round: each group has a box early
    assert {order[x] // 4 for x in range(4)} == {0, 1, 2, 3}


@pytest.mark.parametrize("hdim,q", [(64, 256), (128, 256), (512, 256),
                                    (2048, 256), (1024, 64), (1024, 128),
                                    (1024, 512)])
@pytest.mark.parametrize("f1", [1, 16])
def test_other_bf16_widths_take_the_cuda_core_kernel(hdim, q, f1):
    """The tensor-core kernel is built for the presets' widths alone; every
    other bf16 width keeps the CUDA-core kernel, by the plan."""
    plan = kdec.frame_plan(hdim, q, f1, torch.bfloat16)
    assert plan.route == "fma"
    assert (plan.cluster, plan.lanes) == (kdec.FMA_CLUSTER, kdec.FMA_LANES)


@pytest.mark.parametrize("hdim,q,f1,dtype,reason", [
    (96, 256, 16, torch.bfloat16, "multiples of 64"),
    (1024, 100, 16, torch.float32, "multiples of 64"),
    (1024, 256, 0, torch.bfloat16, "f1"),
    (1024, 256, 16, torch.float16, "dtype"),
    (16384, 256, 16, torch.float32, "shared memory"),
])
def test_other_widths_raise_with_the_reason(hdim, q, f1, dtype, reason):
    with pytest.raises(ValueError, match=reason):
        kdec.frame_plan(hdim, q, f1, dtype)

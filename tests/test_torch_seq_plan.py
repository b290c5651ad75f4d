"""The launch plan of K4's and K5's bf16 chains (``rnn_train.chain_plan``):
checked on the CPU, since the kernels that take it run only on the card.

The plan (hidden units per block, wgmma warpgroups per 64-row pass, rows
per block, ring stages, shared memory, blocks) is a pure function of the
cell, the width and the batch, never of the sequence length; the
library's shared memory (``tc::smem_bytes``, mirrored by
``rnn_train._chain_smem``) fits the H100's 232,448 bytes a block may use;
its blocks all fit on the card at once (no clusters; one block per SM,
two where a block's shared memory allows), as the flags the blocks wait
on require; the units divide the width and the
gate columns of a block are a multiple of wgmma's 8; its row groups cover
the batch.  Every width ``kernel_scope_error`` accepted before the chains
ran on wgmma still has a plan."""

import inspect

import pytest
import torch

from samplernn_pase_tpu_torch.config import PRESETS, preset
from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt

H100_SMEM = 232448             # bytes of shared memory a block may use
H100_SM_SMEM = 233472          # bytes of shared memory per SM
H100_SMS = 132


def _resident(smem: int) -> int:
    """Blocks of a chain the H100 holds at once: per SM as many as its
    shared memory holds (each block also takes 1 KB of reservation and
    its mbarriers)."""
    return H100_SMS * (H100_SM_SMEM // (smem + 1024 + 256))


def _cases():
    """(cell, dim, batch): every preset's training shape, and every width
    and batch the GPU tests and chip_smoke.py run the kernels at."""
    out = set()
    for name in PRESETS:
        exp = preset(name)
        if exp.model.rnn_type in rt.GATES:
            out.add((exp.model.rnn_type, exp.model.dim,
                     exp.train.batch_size))
    for cell in rt.GATES:
        out |= {(cell, 128, 4), (cell, 256, 16), (cell, 40, 130),
                (cell, 1024, 130), (cell, 200, 100), (cell, 1024, 64),
                (cell, 1024, 128)}
    return sorted(out)


CASES = _cases()


def test_plan_takes_no_sequence_length():
    assert list(inspect.signature(rt.chain_plan).parameters) == [
        "cell", "dim", "batch", "w_dtype"]
    assert rt.chain_plan("gru", 1024, 128, torch.float32) is None
    assert rt.chain_plan("gru", 1024, 128) == rt.chain_plan(
        "gru", 1024, 128, torch.bfloat16)


@pytest.mark.parametrize("cell,dim,batch", CASES)
def test_plan_fits_the_card(cell, dim, batch):
    plan = rt.chain_plan(cell, dim, batch)
    assert plan.units in (8, 16) and plan.warpgroups in (1, 2)
    assert dim % plan.units == 0
    g = rt.GATES[cell]
    assert (g * plan.units) % 8 == 0 and plan.units % 8 == 0
    assert plan.chunks in (1, 8)
    assert (rt.MIN_STAGES if plan.chunks == 1 else 2) <= plan.stages
    assert plan.stages <= rt.MAX_STAGES
    if plan.chunks > 1:
        assert dim % 64 == 0
    assert plan.smem == rt._chain_smem(cell, dim, plan.units,
                                       plan.warpgroups, plan.stages,
                                       plan.chunks)
    assert plan.smem <= rt.SMEM_MAX < H100_SMEM
    assert plan.rows % (64 * plan.warpgroups) == 0
    groups = -(-batch // plan.rows)
    assert (groups - 1) * plan.rows < batch <= groups * plan.rows
    assert plan.blocks == dim // plan.units * groups <= _resident(
        plan.smem)


def test_main_paths_plans():
    """The flagship's GRU at B=128 splits its rows over two 16-unit row
    groups (half the L2 reads of one 8-unit group per step); config 2's
    LSTM at B=64 runs 8-unit blocks, all of h_{t-1} and all of a step's
    boxes resident in the ring."""
    fl = rt.chain_plan("gru", 1024, 128)
    assert (fl.units, fl.warpgroups, fl.rows, fl.blocks) == (16, 1, 64, 128)
    assert fl.chunks == 8
    c2 = rt.chain_plan("lstm", 1024, 64)
    assert (c2.units, c2.warpgroups, c2.rows, c2.blocks) == (8, 1, 64, 128)
    assert c2.stages * c2.chunks * 64 >= 1024


# the widths the mma.sync chains (before the wgmma ones) could take in bf16
# on the H100: H/8 blocks of 8 units, two per SM where their shared memory
# (GRU 48*H + 34,816 bytes, LSTM 64*H + 34,816, H rounded up to 128) let
# two share an SM: GRU to 1,664, LSTM to 1,152
@pytest.mark.parametrize("cell,top", [("gru", 1664), ("lstm", 1152)])
def test_scope_keeps_every_width(cell, top):
    for dim in range(8, top + 1, 8):
        for batch in (1, 64, 128, 130, 256):
            plan = rt.chain_plan(cell, dim, batch)
            assert plan.blocks <= _resident(plan.smem)
            assert plan.smem <= rt.SMEM_MAX


def test_plan_rejects_what_it_cannot_tile():
    with pytest.raises(ValueError):
        rt.chain_plan("gru", 100, 4)
    with pytest.raises(ValueError):
        rt.chain_plan("lstm", 4096, 64)

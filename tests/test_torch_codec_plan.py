"""K7's plan (``ops/kernels/codec.codec_plan``), checked on the CPU.  The
plan is a pure function of the shapes, the leading dimensions, the
pointers' offsets within 16 bytes and the card's resident blocks, and the
CUDA side (``csrc/codec.cu``) takes it as an argument and refuses one that
does not fit the call, so what K7 runs on the card is decided, and tested,
here.

The plan: 16-byte accesses only where every row's input and output start
at the same offset within 16 bytes; one wave (blocks never above resident
x SMs); a table iff decode and 2 <= q <= the cap; the same answer
whatever the data.
``walk`` repeats ``codec_body``'s walk of a plan (block ranges of (row,
chunk) items, each row's scalar head and tail around its 16-byte body)
and checks that it writes every element of every row exactly once, with
each 16-byte access aligned on both sides."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from samplernn_pase_tpu_torch.ops.kernels import codec

CSRC = Path(codec.__file__).resolve().parent / "csrc" / "codec.cu"
# (rows, cols, ld_in): cols 1, 3, 5, 1023, 16384 and leading dimensions
# that are and are not multiples of 4
SHAPES = [(37, 1, 1), (37, 1, 6), (5, 3, 3), (5, 3, 7), (9, 5, 5),
          (9, 5, 9), (16, 1023, 1023), (16, 1023, 1027), (3, 16384, 16384),
          (3, 16384, 16387)]
# the card's resident blocks of 256 threads per SM for each direction's
# kernels, and its SMs (NVIDIA H100 80GB HBM3: scripts/codec_bench.py)
H100 = {"encode": (5, 132), "decode": (5, 132)}


def walk(plan, rows, cols, ld_in, ld_out, off_in, off_out):
    """How many times codec_body writes each element of [rows, cols] under
    ``plan``, with the rows of the input and output starting ``off_in`` and
    ``off_out`` elements past a 16-byte line (plus r * ld).  Raises if a
    16-byte access is misaligned on either side."""
    per = plan.threads * plan.vpt
    width = cols // 4 if plan.vec == 4 else cols
    chunks = -(-width // per) if width > per else 1
    items = rows * chunks
    per_block = -(-items // plan.blocks)
    count = np.zeros((rows, cols), np.int64)
    t = np.arange(plan.threads)
    for b in range(plan.blocks):
        for i in range(b * per_block, min((b + 1) * per_block, items)):
            r, c = divmod(i, chunks)
            start_in, start_out = off_in + r * ld_in, off_out + r * ld_out
            head, body = 0, cols
            if plan.vec == 4:
                head = min(-start_in % 4, cols)
                body = (cols - head) >> 2
            for j in range(plan.vpt):
                a = c * per + j * plan.threads + t
                e = head + a[a < body] * plan.vec
                if plan.vec == 4:
                    assert not ((start_in + e) % 4).any()
                    assert not ((start_out + e) % 4).any()
                for k in range(plan.vec):
                    np.add.at(count[r], e + k, 1)
            if plan.vec == 4:
                if c == 0:
                    np.add.at(count[r], t[t < head], 1)
                if c == chunks - 1:
                    e = head + 4 * body + t
                    np.add.at(count[r], e[e < cols], 1)
    return count


@pytest.mark.parametrize("off_in", [0, 1, 2, 3])
@pytest.mark.parametrize("rows,cols,ld_in", SHAPES)
def test_walk_writes_every_element_once(rows, cols, ld_in, off_in):
    """A fresh output (aligned, ld = cols) against inputs whose rows start
    0-3 elements past a 16-byte line: the vector route with each row's
    scalar head and tail where the two agree, the scalar route elsewhere;
    on the H100's wave and on a wave of 3 blocks (items walked in turn)."""
    for resident, sms in (H100["encode"], (3, 1)):
        plan = codec.codec_plan(rows, cols, ld_in, cols, 256, 4 * off_in, 0,
                                resident, sms, decode=False)
        agree = off_in == 0 and (ld_in - cols) % 4 == 0
        assert plan.vec == (4 if agree else 1)
        count = walk(plan, rows, cols, ld_in, cols, off_in, 0)
        assert (count == 1).all(), (plan, np.argwhere(count != 1)[:4])


@pytest.mark.parametrize("align_out", [0, 4, 8, 12])
@pytest.mark.parametrize("align_in", [0, 4, 8, 12])
@pytest.mark.parametrize("ld_in,ld_out", [(1024, 1024), (1027, 1023),
                                          (1030, 1024), (1025, 1024)])
def test_vector_route_only_where_rows_agree(align_in, align_out, ld_in,
                                            ld_out):
    plan = codec.codec_plan(8, 1000, ld_in, ld_out, 256, align_in, align_out,
                            *H100["decode"], decode=True)
    agree = align_in == align_out and (ld_in - ld_out) % 4 == 0
    assert plan.vec == (4 if agree else 1)
    assert plan.vpt in ((1, 4) if agree else (4,))
    assert plan.threads == codec.THREADS
    if agree and align_in:     # rows that agree off a line: heads of 1-3
        count = walk(plan, 8, 1000, ld_in, ld_out, align_in // 4,
                     align_out // 4)
        assert (count == 1).all()


@pytest.mark.parametrize("resident", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("rows,cols", [(0, 16), (1, 1), (128, 1024),
                                       (128, 8192), (64, 16384),
                                       (128, 16384), (1, 2 ** 22),
                                       (4096, 4096)])
def test_blocks_are_one_wave(resident, sms, rows, cols):
    """Never more blocks than the card holds at once, never more than the
    items (at least one), and 1 access a thread where those items fit the
    wave, else 4."""
    plan = codec.codec_plan(rows, cols, cols, cols, 256, 0, 0, resident, sms,
                            decode=True)
    width = cols // plan.vec

    def items(vpt):
        return rows * max(1, -(-width // (codec.THREADS * vpt)))
    assert 1 <= plan.blocks <= resident * sms
    assert plan.blocks <= max(1, items(plan.vpt))
    assert plan.vpt == (1 if items(1) <= resident * sms else 4)


@pytest.mark.parametrize("q", [2, 3, 255, 256, 1024, 4095, 4096, 4097,
                               65536])
def test_table_iff_q_within_the_cap(q):
    """Decode reads a table iff q is within the cap; encode never does."""
    for decode in (True, False):
        plan = codec.codec_plan(4, 64, 64, 64, q, 0, 0, *H100["decode"],
                                decode=decode)
        assert plan.table == (decode and 2 <= q <= codec.TABLE_CAP)


@pytest.mark.parametrize("bad", [dict(q_levels=1), dict(q_levels=0),
                                 dict(rows=-1), dict(resident=0),
                                 dict(sms=0)])
def test_plan_rejects_what_no_launch_can_take(bad):
    kw = dict(rows=4, cols=64, ld_in=64, ld_out=64, q_levels=256,
              align_in=0, align_out=0, resident=5, sms=132, decode=True)
    with pytest.raises(ValueError):
        codec.codec_plan(**{**kw, **bad})


def test_plan_never_reads_the_data(monkeypatch):
    """codec_plan takes shapes and integers only, and plan_for gives the
    same plan for tensors of one layout whatever they hold."""
    params = list(inspect.signature(codec.codec_plan).parameters)
    assert params == ["rows", "cols", "ld_in", "ld_out", "q_levels",
                      "align_in", "align_out", "resident", "sms", "decode"]
    monkeypatch.setattr(codec, "card", lambda index, decode: H100[
        "decode" if decode else "encode"])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    gen = torch.Generator().manual_seed(3)
    plans = set()
    for fill in (torch.zeros, torch.ones):
        lv = fill(128, 1024, dtype=torch.int32)
        wave = torch.rand(128, 1024, generator=gen)
        plans.add(codec.plan_for(lv, wave, 256, True))
        lv.random_(-5, 300, generator=gen)
        plans.add(codec.plan_for(lv, wave, 256, True))
    assert len(plans) == 1


@pytest.mark.parametrize("direction", ["encode", "decode"])
@pytest.mark.parametrize("rows,cols,want", [
    (128, 16384, codec.CodecPlan(4, 4, 256, 512, True)),
    (128, 1024, codec.CodecPlan(4, 1, 256, 128, True))])
def test_plan_at_the_measured_shapes(direction, rows, cols, want):
    """The plans PERF.md records K7's times under: generate()'s request
    at bench.py's length and one StreamPool chunk, contiguous, on the
    H100's resident blocks (encode without the table)."""
    decode = direction == "decode"
    want = want._replace(table=decode)
    for _ in range(2):                                    # deterministic
        assert codec.codec_plan(rows, cols, cols, cols, 256, 0, 0,
                                *H100[direction], decode=decode) == want


@pytest.mark.parametrize("name", ["THREADS", "TABLE_CAP"])
def test_constants_match_the_cuda_source(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m and int(m.group(1)) == getattr(codec, name)

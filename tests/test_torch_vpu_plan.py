"""K8's plan (``scripts/vpu_ceiling.vpu_plan``) and K6's route
(``ops/kernels/decode.lstm_gates_route``), checked on the CPU: both are
pure functions of the shapes that the CUDA side takes as arguments, so
what the kernels run on the card is decided, and tested, here.

The plan: no batch argument (every lane runs the same instructions
whatever B is), deterministic, within the 227 KiB of shared memory a block
can have and above half an SM's (one lane per SM), at least one producer
warp, and slots that cover each step of a frame exactly once in the order
the chain reads them.  Every q the wrapper takes (a multiple of 128 up to
1,024) and f1 in 1..32 has a plan; anything else raises ValueError.  The
route: rows that allow 8-byte accesses take the vector instantiation,
every other shape or stride the scalar one."""

import inspect
import re
from pathlib import Path

import pytest

from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc

QS = (128, 256, 512, 1024)
F1S = (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("f1", F1S)
@pytest.mark.parametrize("q", QS)
def test_vpu_plan_takes_no_batch_and_is_deterministic(q, f1):
    params = list(inspect.signature(vc.vpu_plan).parameters)
    assert params[:2] == ["q", "f1"]
    assert not {"b", "batch", "B", "n_lanes"} & set(params)
    assert vc.vpu_plan(q, f1) == vc.vpu_plan(q, f1)
    assert vc.vpu_plan(q, f1) == vc.vpu_plan(q=q, f1=f1)


@pytest.mark.parametrize("f1", F1S)
@pytest.mark.parametrize("q", QS)
def test_vpu_plan_fits(q, f1):
    plan = vc.vpu_plan(q, f1)
    assert plan.producers >= 1
    assert vc.vpu_warps(plan.producers) <= vc.VPU_MAX_WARPS
    assert plan.slots >= plan.producers    # every producer has a slot
    ring = plan.slots * plan.steps * q * 4 + 16 * plan.slots
    assert plan.smem >= ring
    assert vc.VPU_SMEM_ALONE <= plan.smem <= 227 * 1024
    # more than half an SM's 228 KiB (each block also holds 1 KiB)
    assert 2 * (plan.smem + 1024) > 228 * 1024


@pytest.mark.parametrize("f1", F1S)
@pytest.mark.parametrize("q", QS)
def test_vpu_plan_slots_cover_each_step_of_a_frame_once(q, f1):
    """The chain reads chunk c (steps c*steps .. +steps-1, global step =
    frame*f1 + i) from slot c % slots; producer p fills chunks p, p +
    producers, ...  Over a few frames: every step in exactly one chunk,
    no chunk across a frame's end, each chunk filled by one producer, and
    a slot reused only after the chunk before it in that slot."""
    plan = vc.vpu_plan(q, f1)
    assert f1 % plan.steps == 0
    n_frames = 3
    chunks = n_frames * f1 // plan.steps
    seen = []
    for c in range(chunks):
        steps = range(c * plan.steps, (c + 1) * plan.steps)
        assert len({s // f1 for s in steps}) == 1      # within one frame
        seen.extend(steps)
    assert sorted(seen) == list(range(n_frames * f1))
    owners = [[c for c in range(p, chunks, plan.producers)]
              for p in range(plan.producers)]
    assert sorted(c for o in owners for c in o) == list(range(chunks))
    for o in owners:   # a producer's next chunk is at most one ring turn
        # on, so its wait for the slot is never two phases ahead
        assert all(b - a <= plan.slots for a, b in zip(o, o[1:]))


@pytest.mark.parametrize("q,f1,why", [
    (100, 16, "multiple of 128"), (129, 16, "multiple of 128"),
    (1152, 16, "up to 1024"), (0, 16, "multiple of 128"),
    (256, 0, "1..32"), (256, 33, "1..32"), (256, -1, "1..32")])
def test_vpu_plan_rejects_shapes_k8_does_not_take(q, f1, why):
    with pytest.raises(ValueError, match=why):
        vc.vpu_plan(q, f1)


def test_vpu_plan_takes_only_q_and_f1():
    """The plan is the one owner of K8's choices: no option overrides it,
    in the plan or in the wrapper."""
    assert list(inspect.signature(vc.vpu_plan).parameters) == ["q", "f1"]
    assert "plan" not in inspect.signature(vc.vpu_tail).parameters
    assert vc.vpu_warps(vc.VPU_PRODUCERS) <= vc.VPU_MAX_WARPS


# constants the Python side mirrors from the CUDA sources
@pytest.mark.parametrize("name,source,c_name", [
    ("VPU_MAX_WARPS", "roofline.cu", "MAX_WARPS"),
    ("TRACE_FRAMES", "roofline.cu", "TRACE_FRAMES"),
    ("TRACE_PER", "roofline.cu", "TRACE_PER"),
    ("TRACE_CHUNKS", "roofline.cu", "TRACE_CHUNKS"),
    ("LSTM_VEC", "lstm_gates.cu", "VEC")])
def test_constants_match_the_cuda_sources(name, source, c_name):
    csrc = Path(kdec.__file__).resolve().parent / "csrc"
    found = re.search(rf"constexpr int {c_name} = (\d+);",
                      (csrc / source).read_text())
    py = kdec if name == "LSTM_VEC" else vc
    assert found and int(found.group(1)) == getattr(py, name)


# (hdim, ldg, ldc, g_offset, c_offset) -> route: contiguous aligned rows,
# strided aligned views, 8-byte (not 16-byte) boundaries; hdim 33, odd
# strides and one-float offsets
@pytest.mark.parametrize("args,route", [
    ((1024, 4096, 1024, 0, 0), "vector"),
    ((1000, 8000, 1012, 0, 0), "vector"),
    ((1000, 4000, 1000, 2, 2), "vector"),
    ((33, 132, 33, 0, 0), "scalar"),
    ((33, 264, 66, 0, 0), "scalar"),
    ((1000, 4001, 1000, 0, 0), "scalar"),
    ((1000, 4000, 1001, 0, 0), "scalar"),
    ((1000, 4000, 1000, 1, 0), "scalar"),
    ((1000, 4000, 1000, 0, 3), "scalar")])
def test_lstm_gates_route(args, route):
    assert kdec.lstm_gates_route(*args) == route


def test_plan_and_route_are_defined_once_in_python():
    """The decisions live in Python alone: one definition each in the
    port, and the CUDA sources take them as arguments."""
    port = Path(kdec.__file__).resolve().parents[2]
    sources = [p.read_text() for p in port.rglob("*.py")]
    assert sum(s.count("def vpu_plan(") for s in sources) == 1
    assert sum(s.count("def lstm_gates_route(") for s in sources) == 1
    csrc = Path(kdec.__file__).resolve().parent / "csrc"
    cuda = " ".join(p.read_text() for p in csrc.glob("*.cu*"))
    assert "vpu_plan(" not in cuda.replace("vpu_ceiling.vpu_plan", "")
    assert "lstm_gates_route(" not in cuda.replace(
        "decode.lstm_gates_route", "")

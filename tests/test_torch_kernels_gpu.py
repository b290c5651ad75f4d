"""The CUDA kernels K1-K9 against their plain versions, on the card, the
training route's behaviour on CUDA tensors, pool lanes against solo
streams (batch independence of K1 and K2), and the stacked, 1- and
4-tier and f1=1 models through the kernel loop.

These need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip.
tests/conftest.py imports JAX; on a GPU host without JAX run them with
``python -m pytest tests/test_torch_kernels_gpu.py --noconftest
-p no:cacheprovider``.
"""

import numpy as np
import pytest
import torch

from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
from samplernn_pase_tpu_torch.ops.kernels import megagen

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kdec.plain_numerics()
    return torch.device("cuda")


def _model(dev, dtype="float32", frame_sizes=(4, 2), dim=64,
           rnn_type="gru"):
    cfg = SampleRNNConfig(frame_sizes=frame_sizes, dim=dim, embed_dim=16,
                          compute_dtype=dtype, rnn_type=rnn_type)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    return cfg, params


# K2's shapes: M from a solo stream to the conditioning projection, K from
# a tier input of 4 levels to K9's window, N from K9's output product to
# the bottom upsample (1000 and 70: ragged tiles; 70 also not a multiple
# of 8, which takes the core's plain W loads); every second case reads A
# as int32 levels; A rows are strided (misaligned for 16-byte loads where
# the pad is odd) and so are the rows of ``add``
_M = (1, 5, 128, 3456)
_K = (4, 16, 64, 256, 1024, 4096)
_N = (256, 1000, 1024, 3072, 16384)
GEMM_CASES = [(m, k, _N[(i + j) % len(_N)], (i + j) % 2 == 0)
              for i, m in enumerate(_M) for j, k in enumerate(_K)] + [
    (5, 16, 70, True), (128, 200, 96, False)]


def _gemm_inputs(dev, m, k, n, levels, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    pad = 3 if (m + k) % 2 else 4
    if levels:
        a = torch.randint(0, 256, (m, k + pad), device=dev, generator=gen,
                          dtype=torch.int32)[:, pad:]
    else:
        a = torch.randn(m, k + pad, device=dev, generator=gen)[:, :k]
    w = torch.randn(k, n, device=dev, generator=gen).to(dtype)
    bias = torch.randn(n, device=dev, generator=gen)
    add = torch.randn(m, 2 * n, device=dev, generator=gen)[:, n:]
    return a, w, bias, add


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,levels", GEMM_CASES)
def test_gemm_bias_matches_plain(cuda, dtype, m, k, n, levels):
    a, w, bias, add = _gemm_inputs(cuda, m, k, n, levels, dtype, 1)
    q = 256 if levels else 0
    for b, ad in ((bias, add), (None, None)):
        got = kdec.gemm_bias(a, w, b, ad, levels_q=q)
        want = kdec.gemm_bias_plain(a, w, b, ad, levels_q=q)
        torch.testing.assert_close(got, want, atol=1e-5 * k ** 0.5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,levels", GEMM_CASES)
def test_gemm_bias_conditioning_epilogue_matches_plain(cuda, dtype, m, k, n,
                                                       levels):
    """K2's conditioning epilogue: the kernel's result with it equals its
    result without it plus the selected row, exactly (the add is last),
    and agrees with the plain version; phases cover both rows and the
    clamp of the high row."""
    rows, rate = 3, 10
    a, w, bias, add = _gemm_inputs(cuda, m, k, n, levels, dtype, 11)
    gen = torch.Generator(device=cuda).manual_seed(12)
    # [B, R, N] storage read as [R, B, N]: the projected rows' layout
    ext = torch.randn(m, rows, n, device=cuda, generator=gen).transpose(0, 1)
    phase = torch.randint(0, rate, (m,), device=cuda, generator=gen,
                          dtype=torch.int32)
    q = 256 if levels else 0
    base = kdec.gemm_bias(a, w, bias, add, levels_q=q)
    for pos in (0, 6, 13, 27):
        kw = dict(ext=ext, cphase=phase, pos=pos, cond_rate=rate)
        got = kdec.gemm_bias(a, w, bias, add, levels_q=q, **kw)
        lo = pos // rate
        hi = min(lo + 1, rows - 1)
        bump = (phase.long() + pos % rate >= rate)[:, None]
        row = torch.where(bump, ext[hi], ext[lo])
        torch.testing.assert_close(got, base + row, rtol=0, atol=0)
        torch.testing.assert_close(
            got, kdec.gemm_bias_plain(a, w, bias, add, q, **kw),
            atol=1e-5 * k ** 0.5, rtol=1e-5)


@pytest.mark.parametrize("k,n,levels,with_add,cond", [
    (16, 1024, True, True, True), (64, 1024, True, False, True),
    (256, 1024, False, False, False), (1024, 3072, False, False, False),
    (1024, 4096, False, True, False), (1024, 16384, False, False, False),
    (4096, 1024, False, False, False), (200, 70, True, True, False)])
def test_gemm_bias_rows_independent_of_batch(cuda, k, n, levels, with_add,
                                             cond):
    """bf16 K2: row b of an M=128 call is bit-equal to the same row in an
    M=1 and an M=5 call (the plan does not depend on M: the same partials
    are added in the same order), and two calls are bit-equal."""
    m, rows, rate = 128, 3, 10
    a, w, bias, add = _gemm_inputs(cuda, m, k, n, levels, torch.bfloat16, 5)
    add = add if with_add else None
    q = 256 if levels else 0
    kw = {}
    if cond:
        gen = torch.Generator(device=cuda).manual_seed(6)
        ext = torch.randn(m, rows, n, device=cuda,
                          generator=gen).transpose(0, 1)
        phase = torch.randint(0, rate, (m,), device=cuda, generator=gen,
                              dtype=torch.int32)
        kw = dict(ext=ext, cphase=phase, pos=17, cond_rate=rate)

    def call(lo, hi):
        sub = dict(kw, ext=kw["ext"][:, lo:hi],
                   cphase=kw["cphase"][lo:hi]) if kw else {}
        return kdec.gemm_bias(a[lo:hi], w, bias,
                              None if add is None else add[lo:hi],
                              levels_q=q, **sub)

    full = call(0, m)
    torch.testing.assert_close(call(0, m), full, rtol=0, atol=0)
    for lo, hi in ((0, 1), (127, 128), (7, 12), (60, 65)):
        torch.testing.assert_close(call(lo, hi), full[lo:hi], rtol=0,
                                   atol=0)


def test_gru_gates_matches_plain(cuda):
    gen = torch.Generator().manual_seed(2)
    xg, hg = (torch.randn(7, 3 * 33, generator=gen).to(cuda)
              for _ in range(2))
    h = torch.randn(7, 33, generator=gen).to(cuda)
    torch.testing.assert_close(kdec.gru_gates(xg, hg, h),
                               kdec.gru_gates_plain(xg, hg, h),
                               atol=2e-6, rtol=0)


def test_lstm_gates_matches_plain(cuda):
    gen = torch.Generator().manual_seed(6)
    g = torch.randn(7, 2 * 4 * 33, generator=gen).to(cuda)[:, 4 * 33:]
    c = torch.randn(7, 2 * 33, generator=gen).to(cuda)[:, :33]
    for a, b in zip(kdec.lstm_gates(g, c), kdec.lstm_gates_plain(g, c)):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=0)


# K6's two routes: (B, H, g's and c's column offsets into wider rows,
# the route): config 2's decode shape contiguous, strided views on 16- and
# 8-byte boundaries, and views one or three floats off them
@pytest.mark.parametrize("b,h,g_off,c_off,route", [
    (128, 1024, None, None, "vector"), (37, 1000, 4000, 8, "vector"),
    (37, 1000, 2, 2, "vector"),
    (37, 1000, 1, 0, "scalar"), (37, 1000, 4000, 3, "scalar")])
def test_lstm_gates_routes_match_plain(cuda, b, h, g_off, c_off, route):
    gen = torch.Generator().manual_seed(7)
    if g_off is None:
        g = torch.randn(b, 4 * h, generator=gen).to(cuda)
        c = torch.randn(b, h, generator=gen).to(cuda)
    else:
        g = torch.randn(b, 4 * h + 4004, generator=gen).to(cuda)[
            :, g_off:g_off + 4 * h]
        c = torch.randn(b, h + 12, generator=gen).to(cuda)[:, c_off:c_off + h]
    assert kdec.lstm_gates_route(h, g.stride(0), c.stride(0),
                                 g.data_ptr() % 16 // 4,
                                 c.data_ptr() % 16 // 4) == route
    kdec.reset_launches()
    for a, w in zip(kdec.lstm_gates(g, c), kdec.lstm_gates_plain(g, c)):
        torch.testing.assert_close(a, w, atol=2e-6, rtol=0)
    assert kdec.LAUNCHES["lstm_gates"] == 1


@pytest.mark.parametrize("temp,supplied", [(0.0, False), (0.9, False),
                                           (0.9, True)])
def test_frame_decode_matches_plain_f32(cuda, temp, supplied):
    cfg, params = _model(cuda)
    f1, b = cfg.frame_sizes[0], 6
    mw = kdec.prepare_mlp(params["mlp"], torch.float32, f1)
    gen = torch.Generator().manual_seed(3)
    window = torch.randint(0, 256, (b, f1), generator=gen,
                           dtype=torch.int32).to(cuda)
    cond = torch.randn(b, f1 * cfg.dim, generator=gen).to(cuda)
    bup = torch.randn(f1, cfg.dim, generator=gen).to(cuda)
    noise = (torch.randn(f1, b, 256, generator=gen).to(cuda)
             if supplied else None)
    got = kdec.frame_decode(window, cond, bup, mw, temp, noise, seed=9,
                            pos0=123)
    want = kdec.frame_decode_plain(window, cond, bup, mw, temp, noise,
                                   seed=9, pos0=123)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("temp", [0.9, 0.0])
def test_frame_decode_lane_keys_match_plain_f32(cuda, temp):
    """K1's noise mode 3 (per-lane keys, per-lane positions) against its
    plain version; a partial cluster tile (6 lanes)."""
    from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise
    cfg, params = _model(cuda)
    f1, b = cfg.frame_sizes[0], 6
    mw = kdec.prepare_mlp(params["mlp"], torch.float32, f1)
    gen = torch.Generator().manual_seed(12)
    window = torch.randint(0, 256, (b, f1), generator=gen,
                           dtype=torch.int32).to(cuda)
    cond = torch.randn(b, f1 * cfg.dim, generator=gen).to(cuda)
    keys = np.stack([tnoise.lane_key(5, lane, 2) for lane in range(b)])
    lane_pos = torch.tensor([0, 3, 1 << 32, 17, 5, 9], device=cuda)
    got = kdec.frame_decode(window, cond, None, mw, temp, None, 0, 40,
                            lane_keys=keys, lane_pos=lane_pos)
    want = kdec.frame_decode_plain(window, cond, None, mw, temp, None, 0, 40,
                                   lane_keys=keys, lane_pos=lane_pos)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # lane 3 alone draws the same noise as in the batch
    one = kdec.frame_decode(window[3:4], cond[3:4], None, mw, temp, None, 0,
                            40, lane_keys=keys[3:4], lane_pos=lane_pos[3:4])
    torch.testing.assert_close(one[0], got[3], rtol=0, atol=0)


@pytest.mark.parametrize("temp", [None, 0.9])
def test_pool_lanes_equal_solo_streams_bf16(cuda, temp):
    """A conditioned pool of 8 lanes on the card, bf16, staggered joins
    at different sub-row phases: each lane is bit-equal to a solo B=1
    StreamingGenerator with its stream (and key), which takes K1 with a
    single partial lane tile and K2 with one row."""
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise
    from samplernn_pase_tpu_torch.serve import StreamPool
    cfg = SampleRNNConfig(frame_sizes=(8, 4), dim=128, embed_dim=16,
                          cond_dim=16, cond_rate=20,
                          compute_dtype="bfloat16")
    params = samplernn.init_params(torch.Generator().manual_seed(3), cfg,
                                   cuda)
    gen = torch.Generator().manual_seed(4)
    conds = [torch.randn(int(r), 16, generator=gen).numpy()
             for r in (9, 3, 6, 12, 2, 7, 5, 8)]
    chunk = cfg.lookback
    pool = StreamPool(params, cfg, n_lanes=8, temperature=temp, seed=9,
                      device=cuda)
    kdec.reset_launches()
    outs, joined = [], {}
    for step in range(4):
        for c in range(2 * step, 2 * step + 2):
            joined[pool.start(cond=conds[c])] = step
        outs.append(pool.emit(chunk))
    assert kdec.LAUNCHES["frame_decode"] and kdec.LAUNCHES["gemm_bias"]
    for lane, s0 in joined.items():
        key = None if temp is None else tnoise.lane_key(9, lane, 0)
        sg = tgen.StreamingGenerator(params, cfg, 1, temperature=temp,
                                     stream_keys=key, device=cuda)
        sg.set_cond(conds[lane])
        solo = torch.cat([sg.emit(chunk)[0] for _ in range(4 - s0)])
        got = torch.cat([o[lane] for o in outs[s0:]])
        torch.testing.assert_close(got, solo, rtol=0, atol=0)


@pytest.mark.parametrize("frame_sizes", [(4, 2), (4, 2, 2)])
@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_generate_full_matches_plain_f32(cuda, frame_sizes, temp):
    cfg, params = _model(cuda, frame_sizes=frame_sizes)
    b = 4
    window = torch.full((b, cfg.lookback), 128, dtype=torch.int32,
                        device=cuda)
    states = samplernn.initial_state(params, cfg, b)
    kw = dict(n_top=3, weights_dtype="float32", seed=5)
    got, gs = megagen.generate_full(window, states, temp, params["tiers"],
                                    params["mlp"], **kw)
    want, ws = megagen.generate_full_plain(window, states, temp,
                                           params["tiers"], params["mlp"],
                                           **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, c in zip(gs, ws):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=0)


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_lstm_generate_full_matches_plain_f32(cuda, temp):
    cfg, params = _model(cuda, frame_sizes=(4, 2, 2), rnn_type="lstm")
    b = 4
    window = torch.full((b, cfg.lookback), 128, dtype=torch.int32,
                        device=cuda)
    states = samplernn.initial_state(params, cfg, b)
    kw = dict(n_top=3, rnn_type="lstm", weights_dtype="float32", seed=5)
    kdec.reset_launches()
    got, gs = megagen.generate_full(window, states, temp, params["tiers"],
                                    params["mlp"], **kw)
    assert kdec.LAUNCHES["lstm_gates"] and not kdec.LAUNCHES["gru_gates"]
    want, ws = megagen.generate_full_plain(window, states, temp,
                                           params["tiers"], params["mlp"],
                                           **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, c in zip(gs, ws):
        assert a.shape == (1, 2, b, cfg.dim)
        torch.testing.assert_close(a, c, atol=1e-5, rtol=0)


# K1's tensor-core kernel at the flagship's shape (B=128, dim 1024, q 256,
# f1 16, bf16): rescoring (the plain version, fed the kernel's samples,
# picks the same level) >= 0.99, the reference's bar for its bf16 kernels;
# the window is strided as the generation loop passes it.
def _k1_flagship(dev, b=128):
    from samplernn_pase_tpu_torch.scripts import frame_trace as ft
    args, modes = ft.inputs(torch)
    window, cond, bup, mw = args
    gen = torch.Generator().manual_seed(6)
    noise = -torch.log(-torch.log(torch.rand(ft.F1, ft.B, ft.Q,
                                             generator=gen))).to(dev)
    wide = torch.zeros(ft.B, ft.F1 + 3, dtype=torch.int32, device=dev)
    wide[:, 3:] = window
    kws = {0: dict(temperature=0.0), 1: dict(temperature=0.9, noise=noise),
           2: modes[2], 3: modes[3]}
    return (wide[:, 3:], cond, bup, mw), kws


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_frame_decode_tc_rescores_at_flagship_shape(cuda, mode):
    args, kws = _k1_flagship(cuda)
    mw = args[3]
    plan = kdec.frame_plan(1024, 256, 16, torch.bfloat16)
    assert plan.route == "tc"
    kdec.reset_launches()
    got = kdec.frame_decode(*args, **kws[mode])
    assert kdec.LAUNCHES["frame_decode"] == 1
    assert mw["w_h"].dtype == torch.bfloat16
    again = kdec.frame_decode_plain(*args, **kws[mode], forced=got)
    assert got.min() >= 0 and got.max() < 256
    assert (again == got).float().mean().item() >= 0.99


@pytest.mark.parametrize("mode", [0, 3])
def test_frame_decode_tc_rows_independent_of_batch(cuda, mode):
    """Lane b's samples are bit-equal in B = 1, 8, 37 and 128 launches
    with the same keys and positions (greedy, and per-lane keys): the plan
    never reads B, and a lane's products do not depend on who shares its
    tile."""
    args, kws = _k1_flagship(cuda)
    kw = kws[mode]
    full = kdec.frame_decode(*args, **kw)
    for lo, hi in ((5, 6), (0, 8), (37, 74), (91, 128)):
        part = {k: (v[lo:hi] if k in ("lane_keys", "lane_pos") else v)
                for k, v in kw.items()}
        got = kdec.frame_decode(args[0][lo:hi], args[1][lo:hi], args[2],
                                args[3], **part)
        torch.testing.assert_close(got, full[lo:hi], rtol=0, atol=0)


def _k1_inputs(dev, hdim, q, f1, b, mode):
    gen = torch.Generator().manual_seed(hdim + q + f1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    bf = torch.bfloat16
    mw = {"w_fused": rnd(f1 * q, hdim, scale=0.3).to(bf),
          "b_in": rnd(hdim, scale=0.1),
          "w_h": rnd(hdim, hdim, scale=hdim ** -0.5).to(bf),
          "b_h": rnd(hdim, scale=0.1),
          "w_out": rnd(hdim, q, scale=hdim ** -0.5).to(bf),
          "b_out": rnd(q, scale=0.1)}
    window = torch.randint(0, q, (b, f1), generator=gen,
                           dtype=torch.int32).to(dev)
    cond = rnd(b, f1 * hdim, scale=0.5)
    bup = rnd(f1, hdim, scale=0.1)
    kw = {0: dict(temperature=0.0),
          3: dict(temperature=1.0, seed=0, pos0=40,
                  lane_keys=torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 2),
                                          generator=gen,
                                          dtype=torch.int32).to(dev),
                  lane_pos=torch.arange(b, device=dev) * 3)}[mode]
    return (window, cond, bup, mw), kw


def _k1_rescores_and_lane_5_alone(args, kw, plan=None):
    window, cond, bup, mw = args
    got = kdec.frame_decode(window, cond, bup, mw, **kw, plan=plan)
    again = kdec.frame_decode_plain(window, cond, bup, mw, **kw,
                                    forced=got)
    assert (again == got).float().mean().item() >= 0.99
    one = kdec.frame_decode(window[5:6], cond[5:6], bup, mw, **{
        k: (v[5:6] if k in ("lane_keys", "lane_pos") else v)
        for k, v in kw.items()}, plan=plan)
    torch.testing.assert_close(one[0], got[5], rtol=0, atol=0)


@pytest.mark.parametrize("f1", [1, 4])
@pytest.mark.parametrize("mode", [0, 3])
def test_frame_decode_tc_other_plans(cuda, f1, mode):
    """The tensor-core kernel at f1 = 1 and 4 (its ring and window at
    other sizes), at every ring depth from 8 slots to the plan's:
    rescoring >= 0.99 at B=37 and lane 5 alone equal to lane 5 in the
    batch."""
    plan = kdec.frame_plan(1024, 256, f1, torch.bfloat16)
    assert plan.route == "tc" and plan.stages >= 8
    args, kw = _k1_inputs(cuda, 1024, 256, f1, 37, mode)
    for stages in range(8, plan.stages + 1):
        _k1_rescores_and_lane_5_alone(args, kw, plan._replace(
            stages=stages, smem=plan.smem - (plan.stages - stages) * kdec.BOX))


def test_frame_decode_tc_refuses_shallow_rings(cuda):
    """A ring of fewer than 8 slots is refused at launch (``tc_box_order``
    has no order for some: a warp would wait on a slot a phase behind its
    box and read it before it lands)."""
    args, kws = _k1_flagship(cuda)
    plan = kdec.frame_plan(1024, 256, 16, torch.bfloat16)
    for stages in (4, 6, 7):
        bad = plan._replace(stages=stages, smem=plan.smem + (
            stages - plan.stages) * kdec.BOX)
        with pytest.raises(RuntimeError, match="launch failed"):
            kdec.frame_decode(*args, **kws[0], plan=bad)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", [2, 3])
def test_frame_decode_tc_traced_equals_untraced(cuda, mode):
    """The traced instantiation (launched while a trace buffer is set)
    draws the same samples, bit for bit, as the untraced one at the
    flagship's shape, and writes its phase clocks."""
    from samplernn_pase_tpu_torch.ops.kernels import _build
    from samplernn_pase_tpu_torch.scripts import frame_trace as ft
    args, kws = _k1_flagship(cuda)
    assert kdec.frame_plan(1024, 256, 16, torch.bfloat16).route == "tc"
    want = kdec.frame_decode(*args, **kws[mode])
    got = []
    tr = ft.traced(torch, kdec, _build, lambda: got.append(
        kdec.frame_decode(*args, **kws[mode])))
    torch.testing.assert_close(got[0], want, rtol=0, atol=0)
    assert all(tr[s * 16 + 9] > tr[s * 16] > 0 for s in range(ft.F1))
    torch.testing.assert_close(kdec.frame_decode(*args, **kws[mode]), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("hdim,q", [(512, 256), (2048, 256), (1024, 512)])
@pytest.mark.parametrize("mode", [0, 3])
def test_frame_decode_other_bf16_widths_take_the_cuda_core_kernel(
        cuda, hdim, q, mode):
    """bf16 widths the tensor-core kernel is not built for run the CUDA-core
    kernel by the plan, and still rescore >= 0.99 with lane 5 alone equal
    to lane 5 in the batch."""
    assert kdec.frame_plan(hdim, q, 16, torch.bfloat16).route == "fma"
    _k1_rescores_and_lane_5_alone(*_k1_inputs(cuda, hdim, q, 16, 37, mode))


def test_frame_decode_greedy_never_reads_noise(cuda):
    """At temperature 0 the kernel takes no noise: a NaN block changes
    nothing, on either route."""
    args, _ = _k1_flagship(cuda)
    nan = torch.full((16, 128, 256), float("nan"), device=cuda)
    want = kdec.frame_decode(*args, 0.0)
    torch.testing.assert_close(kdec.frame_decode(*args, 0.0, nan), want,
                               rtol=0, atol=0)
    cfg, params = _model(cuda)
    mw = kdec.prepare_mlp(params["mlp"], torch.float32, 4)
    gen = torch.Generator().manual_seed(8)
    window = torch.randint(0, 256, (6, 4), generator=gen,
                           dtype=torch.int32).to(cuda)
    cond = torch.randn(6, 4 * cfg.dim, generator=gen).to(cuda)
    got = kdec.frame_decode(window, cond, None, mw, 0.0,
                            torch.full((4, 6, 256), float("nan"),
                                       device=cuda))
    torch.testing.assert_close(
        got, kdec.frame_decode_plain(window, cond, None, mw, 0.0),
        rtol=0, atol=0)


def test_bf16_generation_rescores(cuda):
    from samplernn_pase_tpu_torch import generate as tgen
    cfg, params = _model(cuda, "bfloat16", (8, 4), dim=128)
    levels = tgen.generate_levels(params, cfg, 8, cfg.lookback * 4, 0.95,
                                  seed=3)
    assert levels.min() >= 0 and levels.max() < 256
    assert tgen.rescore(params, cfg, levels, 0.95, seed=3) >= 0.99
    assert np.isfinite(levels.float().cpu().numpy()).all()


# ------------------------------------------------ K4 gru_sequence --

def _gru_inputs(dev, n, b, h, seed=4):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    return dict(x=rnd(n, b, h), h0=rnd(b, h, scale=0.5),
                wih=rnd(h, 3 * h, scale=h ** -0.5), bih=rnd(3 * h, scale=0.1),
                whh=rnd(h, 3 * h, scale=h ** -0.5), bhh=rnd(3 * h, scale=0.1),
                dh_seq=rnd(n, b, h), dh_fin=rnd(b, h))


def _near(got, want, atol, rel=0.0):
    err = (got.float() - want.float()).abs().max().item()
    bound = atol + rel * want.float().abs().max().item()
    assert err <= bound, (err, bound)


# float32: the same values up to the order of float32 sums (1e-5, and
# 1e-5 of the largest value for dW and db, the sums over N*B rows).  bf16:
# stored
# values may differ by one rounding where a float32 sum lands on the
# other side of a bf16 rounding boundary; 2**-7 of the largest value is
# two bf16 ulps at that scale.
# bf16 beyond the small shapes: the flagship's plan (B=128: two row groups
# of 16-unit blocks) at N=1 and N=64, B=130 (one row group of 8-unit
# blocks, two passes of 128 rows, 2 rows in the second), and dim 200 (25
# blocks, a count no cluster of 2 or more divides).
@pytest.mark.parametrize("dtype,n,b,h", [("float32", 6, 4, 128),
                                         ("float32", 3, 130, 40),
                                         ("float32", 4, 130, 1024),
                                         ("bfloat16", 5, 16, 256),
                                         ("bfloat16", 3, 130, 40),
                                         ("bfloat16", 4, 130, 1024),
                                         ("bfloat16", 1, 128, 1024),
                                         ("bfloat16", 64, 128, 1024),
                                         ("bfloat16", 3, 100, 200)])
def test_gru_sequence_kernels_match_plain(cuda, dtype, n, b, h):
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    a = _gru_inputs(cuda, n, b, h)
    fargs = (a["x"], a["h0"], a["wih"], a["bih"], a["whh"], a["bhh"], dtype)
    got = rt.gru_sequence_fwd(*fargs)
    want = rt.gru_sequence_fwd_plain(*fargs)
    atol, rel = (1e-5, 0.0) if dtype == "float32" else (0.0, 2 ** -7)
    for g, w in zip(got, want):
        _near(g, w, atol, rel)
    hbuf, _, xg, hg = want
    bargs = (a["x"], a["h0"], a["wih"], a["whh"], hbuf, xg, hg,
             a["dh_seq"], a["dh_fin"], dtype)
    got = rt.gru_sequence_bwd(*bargs)
    want = rt.gru_sequence_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dh0", "dwih", "dbih", "dwhh", "dbhh"),
                          got, want):
        if dtype == "float32":
            _near(g, w, 1e-5, 1e-5 if name[:2] in ("dw", "db") else 0.0)
        else:
            _near(g, w, 0.0, 2 ** -7)
    # a fixed summation order: the same gradient three times
    for _ in range(2):
        again = rt.gru_sequence_bwd(*bargs)
        for g, w in zip(got, again):
            assert torch.equal(g, w)


# ----------------------------------------------- K5 lstm_sequence --

def _lstm_inputs(dev, n, b, h, seed=7):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    return dict(x=rnd(n, b, h), h0=rnd(b, h, scale=0.5),
                c0=rnd(b, h, scale=0.5), wih=rnd(h, 4 * h, scale=h ** -0.5),
                bih=rnd(4 * h, scale=0.1), whh=rnd(h, 4 * h, scale=h ** -0.5),
                bhh=rnd(4 * h, scale=0.1), dh_seq=rnd(n, b, h),
                dh_fin=rnd(b, h), dc_fin=rnd(b, h))


# tolerances as K4's above; bf16 at config 2's shape (B=64, H=1024: all of
# h_{t-1} and a step's boxes resident) at every tier and N=1, and dim 200
# (25 blocks)
@pytest.mark.parametrize("dtype,n,b,h", [("float32", 6, 4, 128),
                                         ("float32", 3, 130, 40),
                                         ("float32", 4, 64, 1024),
                                         ("bfloat16", 5, 16, 256),
                                         ("bfloat16", 3, 130, 40),
                                         ("bfloat16", 64, 64, 1024),
                                         ("bfloat16", 16, 64, 1024),
                                         ("bfloat16", 4, 64, 1024),
                                         ("bfloat16", 1, 64, 1024),
                                         ("bfloat16", 3, 100, 200)])
def test_lstm_sequence_kernels_match_plain(cuda, dtype, n, b, h):
    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    a = _lstm_inputs(cuda, n, b, h)
    fargs = (a["x"], a["h0"], a["c0"], a["wih"], a["bih"], a["whh"],
             a["bhh"], dtype)
    rt.reset_launches()
    got = rt.lstm_sequence_fwd(*fargs)
    want = rt.lstm_sequence_fwd_plain(*fargs)
    atol, rel = (1e-5, 0.0) if dtype == "float32" else (0.0, 2 ** -7)
    for g, w in zip(got, want):
        _near(g, w, atol, rel)
    hbuf, c_seq, _, _, g4 = want
    bargs = (a["x"], a["c0"], a["wih"], a["whh"], hbuf, c_seq, g4,
             a["dh_seq"], a["dh_fin"], a["dc_fin"], dtype)
    got = rt.lstm_sequence_bwd(*bargs)
    want = rt.lstm_sequence_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dh0", "dc0", "dwih", "dbih", "dwhh",
                           "dbhh"), got, want):
        if dtype == "float32":
            _near(g, w, 1e-5, 1e-5 if name[:2] in ("dw", "db") else 0.0)
        else:
            _near(g, w, 0.0, 2 ** -7)
    for _ in range(2):
        again = rt.lstm_sequence_bwd(*bargs)
        for g, w in zip(got, again):
            assert torch.equal(g, w)
    assert rt.LAUNCHES["lstm_sequence_fwd"] == 1
    assert rt.LAUNCHES["lstm_sequence_bwd"] == 3


def test_ineligible_lstm_train_route_raises_on_cuda(cuda):
    """An LSTM width K5 does not tile raises on the card instead of
    scanning."""
    cfg = SampleRNNConfig(frame_sizes=(4, 2), dim=100, embed_dim=8,
                          rnn_type="lstm", compute_dtype="float32",
                          pallas_train_rnn=True)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   cuda)
    state = samplernn.initial_state(params, cfg, 2)
    inputs = torch.randint(0, 256, (2, cfg.lookback + 16),
                           dtype=torch.int32).to(cuda)
    with pytest.raises(ValueError, match="not a multiple of 8"):
        samplernn.forward(params, cfg, inputs, state)


@pytest.mark.parametrize("flag", [True, "auto"])
def test_ineligible_gru_train_route_raises_on_cuda(cuda, flag):
    """A GRU width the sequence kernel does not tile raises on the card
    instead of scanning; pallas_train_rnn=False scans."""
    import dataclasses
    cfg = SampleRNNConfig(frame_sizes=(4, 2), dim=100, embed_dim=8,
                          compute_dtype="float32", pallas_train_rnn=flag)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   cuda)
    state = samplernn.initial_state(params, cfg, 2)
    inputs = torch.randint(0, 256, (2, cfg.lookback + 16),
                           dtype=torch.int32).to(cuda)
    with pytest.raises(ValueError, match="not a multiple of 8"):
        samplernn.forward(params, cfg, inputs, state)
    logits, _ = samplernn.forward(
        params, dataclasses.replace(cfg, pallas_train_rnn=False), inputs,
        state)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("rnn_type,frame_sizes", [("gru", (4, 2)),
                                                  ("lstm", (4, 2, 2))])
def test_train_step_kernel_route_matches_scan(cuda, rnn_type, frame_sizes):
    import dataclasses

    from samplernn_pase_tpu_torch.ops.kernels import rnn_train as rt
    from samplernn_pase_tpu_torch.train.optim import make_optimizer
    from samplernn_pase_tpu_torch.train.trainer import make_train_step
    cfg, params = _model(cuda, dim=64, frame_sizes=frame_sizes,
                         rnn_type=rnn_type)
    names = (f"{rnn_type}_sequence_fwd", f"{rnn_type}_sequence_bwd")
    tx = make_optimizer(1e-3, 1.0)
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (3, cfg.lookback * 5), generator=gen,
                      dtype=torch.int32).to(cuda)
    resets = torch.ones(3, device=cuda)
    out = {}
    for flag in (True, False):
        c = dataclasses.replace(cfg, pallas_train_rnn=flag)
        rt.reset_launches()
        out[flag] = make_train_step(c, tx)(
            params, tx.init(params), samplernn.initial_state(params, c, 3),
            x, x[:, c.lookback:], resets)
        counts = [rt.LAUNCHES[k] for k in names]
        assert counts == ([cfg.n_tiers] * 2 if flag else [0, 0]), rt.LAUNCHES
    assert abs(out[True][3].item() - out[False][3].item()) < 1e-5
    for a, c in zip(out[True][2], out[False][2]):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=0)


# ------------------------------------------- stacked tiers, tier counts --

@pytest.mark.parametrize("rnn_type,frame_sizes", [("gru", (4, 2)),
                                                  ("lstm", (4, 2, 2))])
@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_stacked_generate_full_matches_plain_f32(cuda, rnn_type,
                                                 frame_sizes, temp):
    cfg = SampleRNNConfig(frame_sizes=frame_sizes, dim=64, embed_dim=16,
                          n_rnn=2, rnn_type=rnn_type,
                          compute_dtype="float32")
    params = samplernn.init_params(torch.Generator().manual_seed(1), cfg,
                                   cuda)
    b = 4
    window = torch.full((b, cfg.lookback), 128, dtype=torch.int32,
                        device=cuda)
    states = samplernn.initial_state(params, cfg, b)
    kw = dict(n_top=3, rnn_type=rnn_type, weights_dtype="float32", seed=5)
    kdec.reset_launches()
    got, gs = megagen.generate_full(window, states, temp, params["tiers"],
                                    params["mlp"], **kw)
    per_layer = 1 if rnn_type == "gru" else 0
    steps = 3 * sum(cfg.lookback // s for s in cfg.tier_spans)
    assert kdec.LAUNCHES["gru_gates"] == 2 * steps * per_layer
    want, ws = megagen.generate_full_plain(window, states, temp,
                                           params["tiers"], params["mlp"],
                                           **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, c in zip(gs, ws):
        assert a.shape == states[0].shape
        torch.testing.assert_close(a, c, atol=1e-5, rtol=0)


@pytest.mark.parametrize("frame_sizes", [(1, 8), (8,), (2, 2, 2, 2)])
@pytest.mark.parametrize("temp", [None, 0.9])
def test_other_tier_counts_and_f1_one_match_plain_f32(cuda, frame_sizes,
                                                      temp):
    """f1 = 1 (K1 with a one-slot window), a 1-tier and a 4-tier model:
    generate_levels' kernel route on the card against the same loop on
    the plain versions, and K1 launched once per bottom frame."""
    from samplernn_pase_tpu_torch import generate as tgen
    cfg = SampleRNNConfig(frame_sizes=frame_sizes, dim=64, embed_dim=16,
                          n_rnn=2, compute_dtype="float32")
    params = samplernn.init_params(torch.Generator().manual_seed(2), cfg,
                                   cuda)
    b, n = 6, cfg.lookback * max(2, 32 // cfg.lookback)
    kdec.reset_launches()
    got, st, _ = tgen.generate_levels(params, cfg, b, n, temp, seed=4,
                                      return_state=True, device=cuda)
    assert kdec.LAUNCHES["frame_decode"] == n // frame_sizes[0]
    weights = megagen.prepare(params["tiers"], params["mlp"], torch.float32,
                              kdec.PLAIN)
    want, ws = megagen.run(
        weights, torch.full((b, cfg.lookback), 128, dtype=torch.int32,
                            device=cuda),
        samplernn.initial_state(params, cfg, b), temp or 0.0,
        n // cfg.lookback, 256, kdec.PLAIN, seed=4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, c in zip(st, ws):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=0)


# --------------------------------------------------------- K7 codec --

def test_codec_matches_plain_bit_exact(cuda):
    from samplernn_pase_tpu_torch.ops.kernels import codec
    gen = torch.Generator().manual_seed(7)
    x = (torch.rand(64, 1000, generator=gen) * 2.4 - 1.2).to(cuda)
    codec.reset_launches()
    for q in (256, 1024):
        torch.testing.assert_close(codec.mu_law_encode(x, q),
                                   codec.mu_law_encode_plain(x, q),
                                   rtol=0, atol=0)
        lv = torch.arange(q, dtype=torch.int32, device=cuda).view(4, -1)
        torch.testing.assert_close(codec.mu_law_decode(lv, q),
                                   codec.mu_law_decode_plain(lv, q),
                                   rtol=0, atol=0)
    # rows strided, as a view of the generation buffer
    buf = torch.randint(0, 256, (5, 300), generator=gen,
                        dtype=torch.int32).to(cuda)
    torch.testing.assert_close(codec.mu_law_decode(buf[:, 44:]),
                               codec.mu_law_decode_plain(buf[:, 44:]),
                               rtol=0, atol=0)
    assert codec.LAUNCHES == {"codec_encode": 2, "codec_decode": 3}


def _levels_outside(q):
    """Levels no encode makes, which the plain decode still gives a value."""
    return [-2 ** 31, -1, q, q + 7, 2 ** 31 - 1]


def test_codec_every_float32_and_level(cuda):
    """K7 encode over all 2**32 float32 bit patterns (chunks of 2**26),
    bit-equal to the plain version for every pattern that is not a NaN
    (NaN inputs are counted and printed, not required); decode over every
    level for q in 2, 256, 1024, the table's cap and one above it (the
    formula route), plus levels outside [0, q), bit-equal."""
    from samplernn_pase_tpu_torch.ops.kernels import codec
    chunk = 2 ** 26
    nan_diff = 0
    for lo in range(-2 ** 31, 2 ** 31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32,
                         device=cuda).view(torch.float32).view(1024, -1)
        got = codec.mu_law_encode(x)
        want = codec.mu_law_encode_plain(x)
        nan = torch.isnan(x)
        differ = (got != want) & ~nan
        assert not differ.any(), (
            f"chunk at {lo}: {int(differ.sum())} non-NaN patterns differ, "
            f"first {x[differ][:4].tolist()}")
        nan_diff += int(((got != want) & nan).sum())
    print(f"encode: NaN patterns whose levels differ from the plain "
          f"version's: {nan_diff} of {2 * (2 ** 23 - 1)}")
    for q in (2, 256, 1024, codec.TABLE_CAP, codec.TABLE_CAP + 1):
        lv = torch.tensor(list(range(q)) + _levels_outside(q),
                          dtype=torch.int32, device=cuda)[None]
        assert codec.plan_for(lv, torch.empty_like(lv, dtype=torch.float32),
                              q, True).table == (q <= codec.TABLE_CAP)
        torch.testing.assert_close(codec.mu_law_decode(lv, q),
                                   codec.mu_law_decode_plain(lv, q),
                                   rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("rows,cols,ld", [(37, 1, 6), (5, 3, 7),
                                          (9, 5, 9), (128, 1023, 1027),
                                          (3, 16384, 16387), (4, 1024, 1024),
                                          (128, 8192, 8195),
                                          (64, 16384, 16384)])
def test_codec_misaligned_views_match_plain(cuda, offset, rows, cols, ld):
    """K7 on views whose rows start 0-3 elements past a 16-byte line, with
    leading dimensions that are and are not multiples of 4 (the scalar
    route, or 16-byte accesses with each row's scalar head and tail), and
    on a contiguous copy; levels include ones outside [0, q)."""
    from samplernn_pase_tpu_torch.ops.kernels import codec
    gen = torch.Generator().manual_seed(rows * 7 + offset)
    buf = (torch.rand(rows, ld + offset, generator=gen) * 2.4 - 1.2).to(cuda)
    lbuf = torch.randint(-3, 260, (rows, ld + offset), generator=gen,
                         dtype=torch.int32).to(cuda)
    for x, lv in ((buf[:, offset:offset + cols],
                   lbuf[:, offset:offset + cols]),
                  (buf[:, offset:offset + cols].contiguous(),
                   lbuf[:, offset:offset + cols].contiguous())):
        torch.testing.assert_close(codec.mu_law_encode(x),
                                   codec.mu_law_encode_plain(x),
                                   rtol=0, atol=0)
        torch.testing.assert_close(codec.mu_law_decode(lv),
                                   codec.mu_law_decode_plain(lv),
                                   rtol=0, atol=0)


def test_codec_refuses_a_plan_that_does_not_fit(cuda):
    """srnn_mu_law_encode / _decode launch nothing and return
    cudaErrorInvalidValue (1) for a plan that does not fit the call:
    16-byte accesses on rows whose input and output disagree mod 16
    bytes, other thread counts, no blocks, a (vec, vpt) pair that is not
    built, a table above the cap or for encode; the wrapper's own plan
    launches."""
    import ctypes
    from samplernn_pase_tpu_torch.ops.kernels import _build, codec
    buf = torch.zeros(8, 1028, device=cuda)
    lbuf = torch.zeros(8, 1028, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for symbol, x, out in (("srnn_mu_law_encode", buf[:, 1:1025], lbuf),
                           ("srnn_mu_law_decode", lbuf[:, 1:1025], buf)):
        fn = _build.function("codec", symbol, codec._ARGS)
        good = codec.plan_for(x, out, 256, symbol.endswith("decode"))
        assert good.vec == 1
        for plan, q in ((good._replace(vec=4), 256),
                        (good._replace(threads=128), 256),
                        (good._replace(blocks=0), 256),
                        (good._replace(vpt=2), 256),
                        (good._replace(vpt=3), 256),
                        (good._replace(table=True), codec.TABLE_CAP + 1)):
            args = (ctypes.c_int * 5)(*map(int, plan))
            assert fn(x.data_ptr(), x.stride(0), out.data_ptr(),
                      out.stride(0), 8, 1024, q, args, stream) == 1, plan
        args = (ctypes.c_int * 5)(*map(int, good))
        assert fn(x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
                  8, 1024, 256, args, stream) == 0


# ---------------------------------------------- K8, K9 roofline kernels --

def test_vpu_tail_matches_plain(cuda):
    from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc
    x = vc.inputs(cuda)
    for use_prng in (False, True):
        got, ring = vc.vpu_tail(x["logits"], x["gum"], 3, n_frames=3,
                                use_prng=use_prng, return_ring=True)
        want, wring = vc.vpu_tail_plain(x["logits"], x["gum"], 3,
                                        n_frames=3, use_prng=use_prng)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(ring, wring, rtol=0, atol=0)


def _vpu_inputs(dev, b, q, f1, seed):
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(b, q, generator=gen).to(dev)
    gum = -torch.log(-torch.log(torch.rand(f1, b, q, generator=gen)
                                .clamp(1e-7, 1 - 2 ** -24))).to(dev)
    return logits, gum


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("f1", [1, 4, 16, 32])
@pytest.mark.parametrize("q", [128, 256, 1024])
def test_vpu_tail_matches_plain_over_plans(cuda, q, f1, use_prng):
    """K8's samples and ring bit-equal to the plain version over q, f1,
    frame counts beyond the ring's depth, and batch sizes."""
    from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc
    for n_frames in (1, 3, 17):
        for b in (1, 37, 128):
            logits, gum = _vpu_inputs(cuda, b, q, f1, 10 * n_frames + b)
            got = vc.vpu_tail(logits, gum, 11 + b, n_frames=n_frames,
                              use_prng=use_prng, return_ring=True)
            want = vc.vpu_tail_plain(logits, gum, 11 + b, n_frames=n_frames,
                                     use_prng=use_prng)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("use_prng", [False, True])
def test_vpu_tail_matches_plain_over_many_ring_turns(cuda, use_prng):
    """The flagship's shape over the roofline script's 256 frames: the
    ring of noise slots turns over about 21 times, every slot's barriers
    flip phase again and again."""
    from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc
    x = vc.inputs(cuda)
    n_frames = vc.N_STEPS // vc.F1
    got = vc.vpu_tail(x["logits"], x["gum"], 9, n_frames=n_frames,
                      use_prng=use_prng, return_ring=True)
    want = vc.vpu_tail_plain(x["logits"], x["gum"], 9, n_frames=n_frames,
                             use_prng=use_prng)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_vpu_tail_ties_take_the_lowest_level(cuda):
    """Equal scores everywhere give level 0; -0.0 at a lower level beats
    +0.0 at a higher one (equal, as the compare and torch.argmax see them)
    with every other score below both."""
    from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc
    b, q, f1 = 8, 256, 4
    logits = torch.zeros(b, q, device=cuda)
    gum = torch.zeros(f1, b, q, device=cuda)
    got, ring = vc.vpu_tail(logits, gum, 0, n_frames=3, use_prng=False,
                            return_ring=True)
    assert not got.any()
    want = vc.vpu_tail_plain(logits, gum, 0, n_frames=3, use_prng=False)
    torch.testing.assert_close(ring, want[1], rtol=0, atol=0)
    # pairs (lower, higher): one lane's group, two lanes, the far ends
    pairs = [(5, 6), (5, 200), (0, 255), (130, 131), (3, 129), (64, 96),
             (100, 101), (7, 8)]
    logits = torch.full((b, q), -1.0)
    gum = torch.zeros(f1, b, q)
    for lane, (lo, hi) in enumerate(pairs):
        logits[lane, lo] = -0.0
        logits[lane, hi] = 0.0
        gum[:, lane, lo] = -0.0
    logits, gum = logits.to(cuda), gum.to(cuda)
    assert torch.signbit(logits + vc.TEMPERATURE * gum)[0, 0, 5]
    got, ring = vc.vpu_tail(logits, gum, 0, n_frames=2, use_prng=False,
                            return_ring=True)
    lows = torch.tensor([lo for lo, _ in pairs], dtype=torch.int32,
                        device=cuda)
    torch.testing.assert_close(got, lows[:, None].expand(b, f1), rtol=0,
                               atol=0)
    want = vc.vpu_tail_plain(logits, gum, 0, n_frames=2, use_prng=False)
    torch.testing.assert_close(got, want[0], rtol=0, atol=0)
    torch.testing.assert_close(ring, want[1], rtol=0, atol=0)


def test_mxu_stream_matches_plain(cuda):
    from samplernn_pase_tpu_torch.scripts import vpu_ceiling as vc
    gen = torch.Generator().manual_seed(8)
    b, h, q, f1 = 64, 128, 64, 4

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    args = (rnd(b, f1 * q), rnd((f1 - 1) * q, h, scale=0.05),
            rnd(q, h, scale=0.05), rnd(h, h, scale=0.05),
            rnd(h, q, scale=0.05), rnd(h, f1 * h, scale=0.05))
    got = vc.mxu_stream(*args, n_frames=2)
    want = vc.mxu_stream_plain(*args, n_frames=2)
    # float32 sums in another order: a bf16 rounding of the hidden
    # activations may land on the other side, and every (identical) step
    # repeats it
    err = (got - want).abs().max().item()
    assert err <= 2 ** -7 * want.abs().max().item(), err


# ------------------------------------- megagen.run's CUDA-graph route --

def _seed_tensor(seed, dev):
    bits = seed & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([bits - (1 << 64) if bits >> 63 else bits],
                        dtype=torch.int64, device=dev)


SEEDS = (5, 2 ** 63 + 12345, 2 ** 64 - 1)


@pytest.mark.parametrize("route", ["tc", "fma_bf16", "fma_f32"])
def test_frame_decode_device_seed_equals_host_seed(cuda, route):
    """Mode 2 with the seed read from device memory draws the same noise,
    bit for bit, as the seed passed by value, on both kernels."""
    if route == "tc":
        args, kws = _k1_flagship(cuda)
        kw = dict(kws[2], lane_pos=torch.arange(128, device=cuda) * 5)
    elif route == "fma_bf16":
        args, _ = _k1_inputs(cuda, 512, 256, 16, 37, 0)
        kw = dict(temperature=1.0, pos0=40,
                  lane_pos=torch.arange(37, device=cuda) * 3)
    else:
        cfg, params = _model(cuda)
        mw = kdec.prepare_mlp(params["mlp"], torch.float32, 4)
        gen = torch.Generator().manual_seed(9)
        args = (torch.randint(0, 256, (6, 4), generator=gen,
                              dtype=torch.int32).to(cuda),
                torch.randn(6, 4 * cfg.dim, generator=gen).to(cuda), None,
                mw)
        kw = dict(temperature=0.9, pos0=11)
    mw = args[3]
    assert (kdec.frame_plan(mw["b_in"].shape[0], mw["b_out"].shape[0],
                            args[0].shape[1], mw["w_h"].dtype).route
            == ("tc" if route == "tc" else "fma"))
    host = []
    for seed in SEEDS:
        want = kdec.frame_decode(*args, **dict(kw, seed=seed))
        got = kdec.frame_decode(*args, **dict(
            kw, seed=_seed_tensor(seed, cuda)))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        host.append(want)
    assert not torch.equal(host[0], host[1])


def _graph_model(name, dev):
    """The flagship (configs/c5_gen_b128.json), samplernn-pytorch's
    default (the flagship with n_rnn 2 and weight norm), config 4
    (configs/c4_tts_conditioned.json), config 2 (configs/c2_3tier_lstm.json),
    and small float32 GRU and stacked LSTM models (K1's CUDA-core kernel,
    K6)."""
    import dataclasses
    from pathlib import Path

    from samplernn_pase_tpu_torch.config import load_config
    from samplernn_pase_tpu_torch.ops.matmul import torch_dtype
    root = Path(__file__).resolve().parents[1] / "configs"
    flagship = load_config(root / "c5_gen_b128.json").model
    cfg = {
        "flagship": flagship,
        "srnnpt_default": dataclasses.replace(flagship, n_rnn=2,
                                              weight_norm=True),
        "c4": load_config(root / "c4_tts_conditioned.json").model,
        "c2": load_config(root / "c2_3tier_lstm.json").model,
        "small_f32": SampleRNNConfig(frame_sizes=(4, 2), dim=64,
                                     embed_dim=16, compute_dtype="float32"),
        "small_lstm_f32": SampleRNNConfig(
            frame_sizes=(4, 2, 2), dim=64, embed_dim=16, n_rnn=2,
            rnn_type="lstm", compute_dtype="float32"),
    }[name]
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    weights = megagen.prepare(params["tiers"], params["mlp"],
                              torch_dtype(cfg.compute_dtype))
    return cfg, weights


def _graph_inputs(cfg, dev, b, n_top, call, keyed=False, conditioned=False):
    """The inputs of a ``megagen.run`` call made from ``call``: the window,
    states, positions (per lane when keyed), keys and conditioning rows."""
    gen = torch.Generator().manual_seed(100 + call)
    window = torch.randint(0, cfg.q_levels, (b, cfg.lookback),
                           generator=gen, dtype=torch.int32).to(dev)
    lead = (cfg.n_rnn,) if cfg.rnn_type == "gru" else (cfg.n_rnn, 2)
    states = tuple((0.5 * torch.randn(*lead, b, cfg.dim,
                                      generator=gen)).to(dev)
                   for _ in cfg.frame_sizes)
    pos0 = 1000 * call
    keys = None
    if keyed:
        pos0 = torch.randint(0, 1 << 20, (b,), generator=gen).to(dev)
        keys = torch.randint(0, 2 ** 32, (b, 2), generator=gen).to(dev)
    cond = None
    if conditioned:
        rate = cfg.cond_rate
        rows = (n_top * cfg.lookback - 1) // rate + 2
        cond = (tuple(torch.randn(rows, b, cfg.dim, generator=gen).to(dev)
                      for _ in cfg.frame_sizes),
                torch.randint(0, rate, (b,), generator=gen,
                              dtype=torch.int32).to(dev), rate)
    return window, states, pos0, keys, cond


def _graph_call(cfg, weights, dev, b, n_top, temp, ops, seed, call,
                keyed=False, conditioned=False):
    """megagen.run on ``_graph_inputs``; returns (its result, the launch
    counts)."""
    window, states, pos0, keys, cond = _graph_inputs(cfg, dev, b, n_top, call,
                                                     keyed, conditioned)
    kdec.reset_launches()
    out = megagen.run(weights, window, states, temp, n_top, cfg.q_levels,
                      ops, seed, pos0, None, cond, keys)
    torch.cuda.synchronize()
    return out, dict(kdec.LAUNCHES)


@pytest.fixture
def graphs(monkeypatch):
    """An empty graph cache, and a count of replays."""
    monkeypatch.setattr(megagen, "_GRAPHS", type(megagen._GRAPHS)())
    count = {"replays": 0}
    replay = megagen._Graph.replay

    def counted(self):
        count["replays"] += 1
        replay(self)

    monkeypatch.setattr(megagen._Graph, "replay", counted)
    return count


_B = megagen.BLOCK
LOOP = kdec.Ops(*kdec.KERNELS)      # the same kernels on the launch loop

# (model, lanes, n_top, temperature, lane keys, conditioned)
GRAPH_CASES = {
    "flagship_greedy_remainder": ("flagship", 128, 2 * _B + 3, 0.0, False,
                                  False),
    "flagship_seed_below_a_block": ("flagship", 128, _B - 1, 0.95, False,
                                    False),
    "flagship_seed_one_block": ("flagship", 128, _B, 0.95, False, False),
    "flagship_lane_keys_remainder": ("flagship", 128, 2 * _B + 3, 1.0,
                                     True, False),
    "srnnpt_default_seed": ("srnnpt_default", 128, 3 * _B + 2, 1.0, False,
                            False),
    "c4_conditioned_one_block": ("c4", 128, _B, 1.0, True, True),
    "c4_conditioned_two_blocks": ("c4", 128, 2 * _B, 1.0, True, True),
    "small_f32_seed": ("small_f32", 6, 2 * _B + 3, 0.9, False, False),
    "small_lstm_f32_seed": ("small_lstm_f32", 5, 2 * _B + 1, 0.9, False,
                            False),
}


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graphed_run_equals_launch_loop(cuda, graphs, name):
    """Two calls of one structure with other seeds (one past 2**63),
    positions, states and rows: the first captures (its first block on
    the loop), the second replays from its start.  Levels and final
    states equal the launch loop's bit for bit, and ``LAUNCHES`` counts
    alike."""
    model, b, n_top, temp, keyed, conditioned = GRAPH_CASES[name]
    cfg, weights = _graph_model(model, cuda)
    cond = (((), None, cfg.cond_rate) if conditioned else None)
    blocks = megagen.graph_blocks(n_top, cuda, kdec.KERNELS, None, cond)
    for call, seed in enumerate((7, 2 ** 63 + 5)):
        before = graphs["replays"]
        got, got_n = _graph_call(cfg, weights, cuda, b, n_top, temp,
                                 kdec.KERNELS, seed, call, keyed,
                                 conditioned)
        want, want_n = _graph_call(cfg, weights, cuda, b, n_top, temp, LOOP,
                                   seed, call, keyed, conditioned)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        for a, c in zip(got[1], want[1], strict=True):
            torch.testing.assert_close(a, c, rtol=0, atol=0)
        assert got_n == want_n and got_n["frame_decode"] > 0
        assert graphs["replays"] - before == max(blocks - (call == 0), 0)
    assert len(megagen._GRAPHS) == (1 if blocks else 0)


def test_graphed_run_follows_replaced_and_modified_weights(cuda, graphs):
    """A weight tensor replaced between calls gives a new capture, never a
    replay of the old graph; one modified in place is read anew."""
    cfg, weights = _graph_model("small_f32", cuda)
    n_top = 2 * _B

    def both():
        got, _ = _graph_call(cfg, weights, cuda, 6, n_top, 0.9,
                             kdec.KERNELS, 3, 1)
        want, _ = _graph_call(cfg, weights, cuda, 6, n_top, 0.9, LOOP, 3, 1)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        return got[0]

    first = both()
    (old,) = megagen._GRAPHS
    weights["mlp"]["w_h"] = weights["mlp"]["w_h"] * -1.0
    assert not torch.equal(both(), first)
    # the old graph's w_h died with its last reference: dropped, and a
    # new graph captured and replayed once
    (new,) = megagen._GRAPHS
    assert new != old and graphs["replays"] == 2
    weights["mlp"]["w_out"].mul_(0.5)
    both()
    assert list(megagen._GRAPHS) == [new] and graphs["replays"] == 4


# ------------------------- the GRU's recurrent products beside K1 --

def _in_series(cfg, weights, window, states, temp, n_top, seed, pos0, keys,
               cond):
    """``megagen.run``'s levels and final states from the tier steps in
    series, ``decode.tier_frame`` and ``tier_cell`` on the kernels, every
    ``hg`` on the chain; returns them with the launch counts."""
    tiers, mw = weights["tiers"], weights["mlp"]
    sizes = [t["b_up"].shape[0] for t in tiers]
    spans = [int(np.prod(sizes[:k + 1])) for k in range(len(sizes))]
    lookback, f1 = spans[-1], sizes[0]
    b = window.shape[0]
    buf = torch.empty((b, lookback * (1 + n_top)), dtype=torch.int32,
                      device=window.device)
    buf[:, :lookback] = window
    h = [kdec.decode_state(s, t["layers"]) for s, t in zip(states, tiers)]
    tier_cond = ([None] * len(tiers) if cond is None else
                 [kdec.CondRows(e, cond[1], cond[2]) for e in cond[0]])
    lane_pos = pos0 if isinstance(pos0, torch.Tensor) else None
    pos_off = 0 if lane_pos is not None else pos0
    if keys is not None:
        keys = kdec.kernel_lane_keys(keys, window.device)

    def decode(k, upper, p):
        start = lookback + p
        frame = buf[:, start - spans[k]:start]
        if k == 0:
            _, h[0] = kdec.tier_frame(
                tiers[0], mw, frame, upper, h[0], temp, cfg.q_levels,
                kdec.KERNELS, None, seed, pos_off + p,
                buf[:, start:start + f1], tier_cond[0], p, keys, lane_pos)
            return
        h[k] = kdec.tier_cell(tiers[k], frame, upper, h[k], cfg.q_levels,
                              kdec.KERNELS, tier_cond[k], p)
        up = kdec.gemm_bias(h[k][-1][0], tiers[k]["w_up"],
                            tiers[k]["b_up_flat"])
        for j in range(sizes[k]):
            decode(k - 1, up[:, j * cfg.dim:(j + 1) * cfg.dim],
                   p + j * spans[k - 1])

    kdec.reset_launches()
    for t in range(n_top):
        decode(len(tiers) - 1, None, t * lookback)
    torch.cuda.synchronize()
    return ((buf[:, lookback:], tuple(kdec.model_state(x) for x in h)),
            dict(kdec.LAUNCHES))


# (model, lanes, n_top, temperature, lane keys, conditioned): the stacked
# flagship (n_rnn 2) at 1, 5 and 128 lanes over two blocks and a
# remainder, config 4 in mode 3 (one block replays; longer conditioned
# calls keep the loop), config 2's LSTM tiers (their hg stays on the chain)
OFFCHAIN_CASES = {
    "srnnpt_default_b1_greedy": ("srnnpt_default", 1, 2 * _B + 3, 0.0,
                                 False, False),
    "srnnpt_default_b5_seed": ("srnnpt_default", 5, 2 * _B + 3, 1.0, False,
                               False),
    "srnnpt_default_b128_seed": ("srnnpt_default", 128, 2 * _B + 3, 1.0,
                                 False, False),
    "srnnpt_default_b128_greedy": ("srnnpt_default", 128, 2 * _B, 0.0,
                                   False, False),
    "c4_b128_mode3_one_block": ("c4", 128, _B, 1.0, True, True),
    "c4_b5_mode3_one_block": ("c4", 5, _B, 1.0, True, True),
    "c4_b128_mode3_loop": ("c4", 128, 2 * _B + 3, 1.0, True, True),
    "c2_lstm_b128_seed": ("c2", 128, 2 * _B + 1, 1.0, False, False),
}


@pytest.mark.parametrize("name", sorted(OFFCHAIN_CASES))
def test_offchain_run_equals_tier_steps_in_series(cuda, graphs, name):
    """``megagen.run`` with the GRU tiers' next ``hg`` beside K1, on the
    graph route (two calls: the first captures, the second replays from
    its start) and on the loop, against the tier steps in series: levels
    and final states bit-equal, launch counts equal (config 2: 121 a top
    frame)."""
    model, b, n_top, temp, keyed, conditioned = OFFCHAIN_CASES[name]
    cfg, weights = _graph_model(model, cuda)
    for call, seed in enumerate((7, 2 ** 63 + 5)):
        inputs = _graph_inputs(cfg, cuda, b, n_top, call, keyed, conditioned)
        window, states, pos0, keys, cond = inputs
        want, want_n = _in_series(cfg, weights, window, states, temp, n_top,
                                  seed, pos0, keys, cond)
        for ops in (kdec.KERNELS, LOOP):
            got, got_n = _graph_call(cfg, weights, cuda, b, n_top, temp, ops,
                                     seed, call, keyed, conditioned)
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
            for a, c in zip(got[1], want[1], strict=True):
                torch.testing.assert_close(a, c, rtol=0, atol=0)
            assert got_n == want_n
    if model == "c2":
        assert sum(want_n[k] for k in ("frame_decode", "gemm_bias",
                                       "gru_gates", "lstm_gates")) \
            == 121 * n_top
    elif not conditioned or n_top <= _B:
        assert graphs["replays"] > 0


def test_pool_lanes_equal_solo_streams_flagship_width(cuda):
    """Config 4 at its width (K1's tensor-core kernel on 8 clusters, the
    products beside it on the SMs it leaves): a 128-lane pool with joins
    at three chunk boundaries, 1,024-sample chunks (a graph block each);
    each joined lane bit-equal to a solo B=1 StreamingGenerator with its
    rows and key."""
    from samplernn_pase_tpu_torch import generate as tgen
    from samplernn_pase_tpu_torch.ops.kernels import noise as tnoise
    from samplernn_pase_tpu_torch.serve import StreamPool
    cfg, _ = _graph_model("c4", cuda)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   cuda)
    gen = torch.Generator().manual_seed(6)
    chunk, temp, seed = 1024, 1.0, 9
    pool = StreamPool(params, cfg, n_lanes=128, temperature=temp, seed=seed,
                      device=cuda)
    joined, outs = {}, []
    for step in range(3):
        for _ in range(40):
            rows = torch.randn(int(torch.randint(20, 60, (1,),
                                                 generator=gen)),
                               cfg.cond_dim, generator=gen).numpy()
            joined[pool.start(cond=rows)] = (step, rows)
        outs.append(pool.emit(chunk))
    for lane in (0, 39, 40, 77, 119):
        s0, rows = joined[lane]
        sg = tgen.StreamingGenerator(
            params, cfg, 1, temperature=temp,
            stream_keys=tnoise.lane_key(seed, lane, 0), device=cuda)
        sg.set_cond(rows)
        solo = torch.cat([sg.emit(chunk)[0] for _ in range(3 - s0)])
        got = torch.cat([o[lane] for o in outs[s0:]])
        torch.testing.assert_close(got, solo, rtol=0, atol=0)

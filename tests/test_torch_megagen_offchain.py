"""``megagen.run``'s schedule of the GRU tiers' recurrent products
(``hg = h @ w_hh + b_hh``) beside K1, the parts that need no card: when
it engages (``offchain``), which products leave the chain and where they
are launched, the ``offchain`` and ``hg`` attrs of the span, and that the
reordered launches compute the same levels and states as the chain, run
here through the kernels' plain versions on CPU tensors.  On the card
(``tests/test_torch_kernels_gpu.py``) the schedule is held against the
tier steps run in series."""

import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
from samplernn_pase_tpu_torch.ops.kernels import megagen
from samplernn_pase_tpu_torch.utils import profiling

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
B = megagen.BLOCK
LOOP = kdec.Ops(*kdec.KERNELS)


@pytest.mark.parametrize("ops,device,want", [
    (kdec.KERNELS, CUDA, True), (LOOP, CUDA, True), (kdec.PLAIN, CUDA, False),
    (kdec.KERNELS, CPU, False), (LOOP, CPU, False), (kdec.PLAIN, CPU, False)])
def test_offchain_engages_with_k2_on_cuda(ops, device, want):
    assert megagen.offchain(ops, device) is want


def _model(rnn_type="gru", n_rnn=2, frame_sizes=(4, 2)):
    cfg = SampleRNNConfig(frame_sizes=frame_sizes, dim=16, embed_dim=8,
                          n_rnn=n_rnn, rnn_type=rnn_type,
                          compute_dtype="float32")
    params = samplernn.init_params(torch.Generator().manual_seed(5), cfg,
                                   "cpu")
    return cfg, megagen.prepare(params["tiers"], params["mlp"], torch.float32)


def _inputs(cfg, b, n_top, seed=0, cond=False):
    gen = torch.Generator().manual_seed(seed)
    window = torch.randint(0, 256, (b, cfg.lookback), generator=gen,
                           dtype=torch.int32)
    lead = (cfg.n_rnn,) if cfg.rnn_type == "gru" else (cfg.n_rnn, 2)
    states = tuple(0.5 * torch.randn(*lead, b, cfg.dim, generator=gen)
                   for _ in cfg.frame_sizes)
    rows = None
    if cond:
        rate = 12
        n = (n_top * cfg.lookback - 1) // rate + 2
        rows = (tuple(torch.randn(n, b, cfg.dim, generator=gen)
                      for _ in cfg.frame_sizes),
                torch.randint(0, rate, (b,), generator=gen,
                              dtype=torch.int32), rate)
    return window, states, rows


class _Log:
    """Ops that log each launch: ("K1",), ("hg", tier, pdl) for a product
    given an ``out`` (beside K1) and ("K2",) / ("K3",) / ("K6",) for the
    rest, running the kernels' plain versions."""

    def __init__(self, weights):
        self.events = []
        self.w_hh = {id(lw["w_hh"]): k for k, t in enumerate(weights["tiers"])
                     for lw in t["layers"]}

    def gemm(self, a, w, *args, out=None, pdl=False, **kw):
        if out is None:
            self.events.append(("K2",))
        else:
            self.events.append(("hg", self.w_hh[id(w)], pdl))
        return kdec.gemm_bias(a, w, *args, out=out, pdl=pdl, **kw)

    def gru(self, *args):
        self.events.append(("K3",))
        return kdec.gru_gates(*args)

    def lstm(self, *args):
        self.events.append(("K6",))
        return kdec.lstm_gates(*args)

    def frame(self, *args):
        self.events.append(("K1",))
        return kdec.frame_decode(*args)

    def ops(self):
        return kdec.Ops(self.gemm, self.gru, self.lstm, self.frame)


def _frames(cfg, weights, top, ops, beside, b=3, temp=1.0, cond=False,
            lane_keys=None):
    """``megagen._frames`` over ``top`` on fresh inputs -> (levels, final
    states, counts)."""
    window, states, rows = _inputs(cfg, b, top.stop, cond=cond)
    buf = torch.zeros((b, cfg.lookback * (1 + top.stop)), dtype=torch.int32)
    buf[:, top.start * cfg.lookback:(top.start + 1) * cfg.lookback] = window
    h = [kdec.decode_state(s, t["layers"])
         for s, t in zip(states, weights["tiers"])]
    tier_cond = ([None] * len(states) if rows is None else
                 [kdec.CondRows(e, rows[1], rows[2]) for e in rows[0]])
    pos = None if lane_keys is None else torch.tensor([0, 9, 40][:b])
    counts = megagen._frames(
        weights["tiers"], weights["mlp"], buf, h, top, temp, 256, ops, 7, 0,
        pos, tier_cond, lane_keys, beside=beside)
    return buf, [kdec.model_state(x) for x in h], counts


def _beside_each_k1(events):
    """The tier of each product launched after each K1, and its
    ``pdl``."""
    out = []
    for e in events:
        if e == ("K1",):
            out.append([])
        elif e[0] == "hg":
            out[-1].append(e[1:])
    return out


@pytest.mark.parametrize("top", [range(3), range(2, 5), range(1)])
def test_which_products_go_beside_k1_two_tiers(top):
    """Flagship-shaped (2 tiers, 2 GRU layers): K1 of a top frame's first
    bottom frame takes the top tier's next products and the bottom's, the
    others the bottom's; the range's first step of each tier computes its
    own, and no product is made past the range.  Every product is a
    programmatic dependent of the kernel before it."""
    cfg, weights = _model()
    log = _Log(weights)
    _, _, counts = _frames(cfg, weights, top, log.ops(), True)
    n = len(top)
    both = [(1, True), (1, True), (0, True), (0, True)]
    bottom = [(0, True), (0, True)]
    want = []
    for t in range(n):
        want += [both, bottom] if t < n - 1 else [bottom, []]
    assert _beside_each_k1(log.events) == want
    # hg products: 2 layers x (one top step + 2 bottom steps) a top frame;
    # the range's first top step's and first bottom step's stay on the
    # chain
    assert counts == (6 * n - 4, 6 * n)
    assert sum(e[0] == "hg" for e in log.events) == 6 * n - 4
    # on the chain: a tier step's input, xg a layer and the upsample (4 a
    # top step, 4 a bottom step), and the 4 hg kept there
    assert log.events.count(("K2",)) == 12 * n + 4
    assert log.events.count(("K3",)) == 6 * n


def test_which_products_go_beside_k1_three_tiers():
    """A 3-tier GRU of one layer a tier: every tier's next product goes
    beside the first K1 under its step."""
    cfg, weights = _model(n_rnn=1, frame_sizes=(2, 2, 2))
    log = _Log(weights)
    _, _, counts = _frames(cfg, weights, range(2), log.ops(), True)
    # top frame 0: K1 of frames 0-3 (tier 1 steps at frames 0 and 2)
    assert _beside_each_k1(log.events) == [
        [(2, True), (1, True), (0, True)], [(0, True)],
        [(1, True), (0, True)], [(0, True)],
        [(1, True), (0, True)], [(0, True)],
        [(0, True)], []]
    assert counts == (14 - 3, 14)


def test_lstm_tiers_keep_their_products_on_the_chain():
    cfg, weights = _model(rnn_type="lstm")
    log = _Log(weights)
    _, _, counts = _frames(cfg, weights, range(3), log.ops(), True)
    assert counts == (0, 0)
    assert not any(e[0] == "hg" for e in log.events)
    assert log.events.count(("K6",)) == 3 * 3 * 2


@pytest.mark.parametrize("rnn,n_rnn,frame_sizes,temp,keyed,cond", [
    ("gru", 2, (4, 2), 1.0, False, False),
    ("gru", 2, (4, 2), 0.0, False, False),
    ("gru", 1, (4, 2), 0.9, True, True),
    ("gru", 1, (2, 2, 2), 1.0, False, False),
    ("gru", 1, (4,), 1.0, False, False),
    ("lstm", 2, (4, 2), 1.0, False, False),
])
def test_reorder_changes_nothing_on_the_cpu(rnn, n_rnn, frame_sizes, temp,
                                            keyed, cond):
    """The kernels' plain versions on CPU tensors, the products beside K1
    against the chain: the same levels and states, bit for bit."""
    cfg, weights = _model(rnn, n_rnn, frame_sizes)
    keys = kdec.kernel_lane_keys(torch.tensor([[1, 2], [3, 4], [5, 6]])) \
        if keyed else None
    kw = dict(b=3, temp=temp, cond=cond, lane_keys=keys)
    got = _frames(cfg, weights, range(1, 4), kdec.KERNELS, True, **kw)
    want = _frames(cfg, weights, range(1, 4), kdec.KERNELS, False, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, c in zip(got[1], want[1], strict=True):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert got[2][1] == want[2][1] and want[2][0] == 0


class _EagerGraph(megagen._Graph):
    """A graph whose replay runs its recorded block again."""

    def capture(self, *args):
        self.args = args

    def replay(self):
        self.counts = self.block(*self.args)


@pytest.fixture
def beside_on_cpu(monkeypatch):
    """``run`` on CPU tensors puts the products beside K1 and takes the
    graph route, replaying eagerly."""
    blocks = megagen.graph_blocks
    monkeypatch.setattr(megagen, "graph_blocks",
                        lambda n, dev, *a: blocks(n, CUDA, *a))
    monkeypatch.setattr(megagen, "_Graph", _EagerGraph)
    monkeypatch.setattr(megagen, "_GRAPHS", type(megagen._GRAPHS)())
    monkeypatch.setattr(megagen, "offchain",
                        lambda ops, dev: ops.gemm is kdec.gemm_bias)


def _run(cfg, weights, n_top, ops, b=3, cond=False):
    window, states, rows = _inputs(cfg, b, n_top, seed=n_top, cond=cond)
    return megagen.run(weights, window, states, 1.0, n_top, 256, ops, 11,
                       0, None, rows)


@pytest.mark.parametrize("n_rnn,n_top,cond", [
    (2, 2 * B + 3, False), (1, B, True), (2, 3, False)])
def test_run_beside_equals_the_chain(beside_on_cpu, n_rnn, n_top, cond):
    cfg, weights = _model(n_rnn=n_rnn)
    got = _run(cfg, weights, n_top, kdec.KERNELS, cond=cond)
    want = _run(cfg, weights, n_top, kdec.PLAIN, cond=cond)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, c in zip(got[1], want[1], strict=True):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_the_span_counts_the_products_beside_k1(beside_on_cpu):
    """Per ``_frames`` range (the first block on the loop, each replay, the
    remainder) each tier's first step keeps its products on the chain;
    the plain versions and LSTM tiers compute none beside K1."""
    gru, weights = _model(n_rnn=2)
    lstm, lstm_weights = _model(rnn_type="lstm")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for n_top in (2 * B + 3, 2 * B + 3, 1):
            _run(gru, weights, n_top, kdec.KERNELS)
        _run(gru, weights, 2 * B, kdec.PLAIN)
        _run(lstm, lstm_weights, B + 1, kdec.KERNELS)
    runs = [s for s in profiling.spans() if s.name == "megagen.run"]
    profiling.clear()
    block, rest = 6 * B, 6 * 3          # hg of a block and of 3 top frames
    assert [(s.attrs["graphed"], s.attrs["offchain"], s.attrs["hg"])
            for s in runs] == [
        (B, 2 * (block - 4) + rest - 4, 2 * block + rest),
        (2 * B, 2 * (block - 4) + rest - 4, 2 * block + rest),
        (0, 2, 6),
        (0, 0, 2 * block),
        (0, 0, 0)]


# --------------------- the benchmark's readers of the span's counts --

READERS = ["megagen.offchain_share.gen", "megagen.offchain_share.stream"]
S = 1_000_000_000


def _read(metric, t0=100.0, window_s=10.0, traced_s=2.0):
    """The reader over a window of ``window_s`` from ``t0`` (seconds on
    the spans' clock) whose last ``traced_s`` were traced."""
    from benchmark import harness
    path = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
    mod = harness.load_module(path / f"{metric}.py", f"reader_{metric}")
    return mod.read(SimpleNamespace(
        trace={"window_s": traced_s, "busy_s": 1.0}, window_t0=t0,
        window_s=window_s))


def _spans(monkeypatch, spans):
    """``profiling.spans`` returning ``spans``, each (name, t0, attrs),
    0.1 s long."""
    got = []
    for i, (name, t0, attrs) in enumerate(spans):
        s = profiling.Span(i, name, -1, attrs)
        s.t0, s.e0 = round(t0 * S), round(t0 * S)
        s.t1 = s.t0 + S // 10
        got.append(s)
    monkeypatch.setattr(profiling, "spans", lambda: got)


@pytest.mark.parametrize("metric", READERS)
def test_readers_take_the_tails_share(metric, monkeypatch):
    run = dict(top_frames=16, lanes=4, graphed=16)
    _spans(monkeypatch, [
        ("megagen.run", 108.1, dict(run, offchain=156, hg=160)),
        ("megagen.run", 108.3, dict(run, offchain=76, hg=80)),
        ("megagen.run", 108.5, dict(run, offchain=0, hg=0)),     # LSTM
        ("pool.emit", 108.7, {}),
        ("megagen.run", 101.0, dict(run, offchain=0, hg=160))])  # before
    assert _read(metric) == pytest.approx(100.0 * 232 / 240)


@pytest.mark.parametrize("metric", READERS)
def test_readers_find_nothing_to_read(metric, monkeypatch):
    run = dict(top_frames=16, lanes=4, graphed=16)
    _spans(monkeypatch, [("megagen.run", 108.1, run)])   # no offchain attr
    assert _read(metric) is None
    _spans(monkeypatch, [("megagen.run", 108.1,
                          dict(run, offchain=0, hg=0))])  # LSTM tiers only
    assert _read(metric) is None
    _spans(monkeypatch, [("megagen.run", 108.1,
                          dict(run, offchain=4, hg=8))])
    assert _read(metric, t0=50.0) is None                # before the tail
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(metric) is None
    monkeypatch.delattr(profiling, "spans")              # a port with none
    assert _read(metric) is None


@pytest.mark.parametrize("metric", READERS)
def test_readers_on_a_traced_run_of_the_loop(beside_on_cpu, metric,
                                             monkeypatch):
    """Calls of two blocks of the stacked model, products beside K1 on the
    CPU through the stand-in graph: 4 of a block's 96 ``hg`` on the
    chain."""
    cfg, weights = _model(n_rnn=2)
    profiling.clear()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            _run(cfg, weights, 2 * B, kdec.KERNELS)
    span = time.perf_counter() - t0 + 1.0
    try:
        got = _read(metric, t0=t0 - 1.0, window_s=span, traced_s=span)
    finally:
        profiling.clear()
    assert got == pytest.approx(100.0 * (96 - 4) / 96)

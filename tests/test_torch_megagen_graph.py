"""``megagen.run``'s CUDA-graph route, the parts that need no card: which
calls replay blocks (``graph_blocks``), what a graph is keyed by
(``graph_key``), the bounded cache, and the chaining of blocks through the
static buffers, run here with a graph whose replay runs its recorded block
again (the kernels' plain versions on CPU tensors) against the launch
loop.  The captured graph itself is tested on the card
(``tests/test_torch_kernels_gpu.py``)."""

import gc

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
LOOP = kdec.Ops(*kdec.KERNELS)     # the same kernels, on the launch loop
COND = ((), None, 160)             # a conditioned call, as graph_blocks
                                   # sees it


@pytest.mark.parametrize("n_top,device,ops,gumbel,cond,want", [
    (B - 1, CUDA, kdec.KERNELS, None, None, 0),
    (B, CUDA, kdec.KERNELS, None, None, 1),
    (B + 1, CUDA, kdec.KERNELS, None, None, 1),
    (5 * B + 2, CUDA, kdec.KERNELS, None, None, 5),
    (1250, CUDA, kdec.KERNELS, None, None, 78),     # 80,000 samples
    (5 * B, CPU, kdec.KERNELS, None, None, 0),
    (5 * B, CUDA, kdec.PLAIN, None, None, 0),
    (5 * B, CUDA, LOOP, None, None, 0),
    (5 * B, CUDA, kdec.KERNELS, "gumbel", None, 0),
    (B, CUDA, kdec.KERNELS, None, COND, 1),
    (B - 1, CUDA, kdec.KERNELS, None, COND, 0),
    (B + 1, CUDA, kdec.KERNELS, None, COND, 0),
    (4 * B, CUDA, kdec.KERNELS, None, COND, 0),
])
def test_graph_blocks(n_top, device, ops, gumbel, cond, want):
    assert megagen.graph_blocks(n_top, device, ops, gumbel, cond) == want


@pytest.mark.parametrize("temperature,gumbel,lane_keys,want", [
    (0.0, None, None, 0), (None, "g", "k", 0), (1.0, "g", None, 1),
    (0.9, None, "k", 3), (1.0, None, None, 2)])
def test_noise_mode(temperature, gumbel, lane_keys, want):
    assert kdec.noise_mode(temperature, gumbel, lane_keys) == want


def _model(rnn_type="gru", n_rnn=1, frame_sizes=(4, 2)):
    cfg = SampleRNNConfig(frame_sizes=frame_sizes, dim=16, embed_dim=8,
                          n_rnn=n_rnn, rnn_type=rnn_type,
                          compute_dtype="float32")
    params = samplernn.init_params(torch.Generator().manual_seed(3), cfg,
                                   "cpu")
    weights = megagen.prepare(params["tiers"], params["mlp"], torch.float32)
    return cfg, params, weights


def _cond(cfg, b, n_top, seed=0, rate=12):
    gen = torch.Generator().manual_seed(seed)
    rows = (n_top * cfg.lookback - 1) // rate + 2
    ext = tuple(torch.randn(rows, b, cfg.dim, generator=gen)
                for _ in cfg.frame_sizes)
    return ext, torch.randint(0, rate, (b,), generator=gen,
                              dtype=torch.int32), rate


def test_graph_key_tells_structures_apart():
    cfg, _, weights = _model()
    window = torch.full((4, cfg.lookback), 128, dtype=torch.int32)
    base = megagen.graph_key(weights, window, 1.0, 256, 2, None)
    assert base == megagen.graph_key(weights, window.clone(), 1.0, 256, 2,
                                     None)
    assert B in base
    other = dict(weights, mlp=dict(weights["mlp"],
                                   w_h=weights["mlp"]["w_h"].clone()))
    cond = _cond(cfg, 4, B)
    for key in (megagen.graph_key(other, window, 1.0, 256, 2, None),
                megagen.graph_key(weights, window[:3], 1.0, 256, 2, None),
                megagen.graph_key(weights, window, 0.9, 256, 2, None),
                megagen.graph_key(weights, window, 1.0, 128, 2, None),
                megagen.graph_key(weights, window, 1.0, 256, 3, None),
                megagen.graph_key(weights, window, 1.0, 256, 2, cond),
                megagen.graph_key(weights, window, 1.0, 256, 2,
                                  cond[:2] + (10,)),
                megagen.graph_key(weights, window, 1.0, 256, 2,
                                  _cond(cfg, 4, 2 * B))):
        assert key != base
    bf16 = megagen.prepare(*(_model()[1][k] for k in ("tiers", "mlp")),
                           torch.bfloat16)
    assert megagen.graph_key(bf16, window, 1.0, 256, 2, None) != base


class _EagerGraph(megagen._Graph):
    """A graph whose replay runs its recorded block again."""

    captures = replays = 0

    def capture(self, *args):
        type(self).captures += 1
        self.args = args

    def replay(self):
        type(self).replays += 1
        self.block(*self.args)


@pytest.fixture
def eager(monkeypatch):
    """``run`` on CPU tensors takes the graph route, replaying eagerly."""
    blocks = megagen.graph_blocks
    monkeypatch.setattr(megagen, "graph_blocks",
                        lambda n, dev, *a: blocks(n, CUDA, *a))
    monkeypatch.setattr(megagen, "_Graph", _EagerGraph)
    monkeypatch.setattr(megagen, "_GRAPHS", type(megagen._GRAPHS)())
    _EagerGraph.captures = _EagerGraph.replays = 0
    return _EagerGraph


def _call(cfg, weights, b, n_top, temp, ops, seed, pos0, lane_keys=None,
          cond=None, start=0):
    gen = torch.Generator().manual_seed(start + 7)
    window = torch.randint(0, 256, (b, cfg.lookback), generator=gen,
                           dtype=torch.int32)
    lead = (cfg.n_rnn,) if cfg.rnn_type == "gru" else (cfg.n_rnn, 2)
    states = tuple(0.5 * torch.randn(*lead, b, cfg.dim, generator=gen)
                   for _ in cfg.frame_sizes)
    return megagen.run(weights, window, states, temp, n_top, 256, ops, seed,
                       pos0, None, cond, lane_keys)


def _same(got, want):
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, c in zip(got[1], want[1], strict=True):
        assert a.shape == c.shape
        torch.testing.assert_close(a, c, rtol=0, atol=0)


KEYS = torch.tensor([[1, 2], [3, 2 ** 32 - 1], [5, 6], [7, 8]])

# (name, model, n_top, temperature, lane keys, conditioned, blocks
# replayed by the first call and by the second)
CASES = [
    ("greedy_two_blocks_and_remainder", ("gru", 1), 2 * B + 3, 0.0, False,
     False, (1, 2)),
    ("seed_three_blocks", ("gru", 1), 3 * B, 1.0, False, False, (2, 3)),
    ("lane_keys_remainder", ("gru", 1), B + 5, 0.9, True, False, (0, 1)),
    ("conditioned_one_block", ("gru", 1), B, 1.0, True, True, (0, 1)),
    ("below_one_block", ("gru", 1), B - 1, 1.0, False, False, (0, 0)),
    ("stacked_lstm", ("lstm", 2), 2 * B + 1, 1.0, False, False, (1, 2)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_replayed_blocks_equal_the_launch_loop(eager, case):
    """Two calls with other seeds, positions and states: the first (a new
    structure) runs its first block on the loop and captures it, the
    second replays from its start; both equal the loop bit for bit."""
    _, (rnn, n_rnn), n_top, temp, keyed, conditioned, replays = case
    cfg, _, weights = _model(rnn, n_rnn)
    b = 4
    for i, (seed, pos0) in enumerate(((5, 0), (2 ** 63 + 9, 1000))):
        if keyed:
            pos0 = torch.tensor([0, 40, 7, 300]) + pos0
        kw = dict(lane_keys=KEYS if keyed else None,
                  cond=_cond(cfg, b, n_top, i) if conditioned else None,
                  start=i)
        before = eager.replays
        got = _call(cfg, weights, b, n_top, temp, kdec.KERNELS, seed, pos0,
                    **kw)
        want = _call(cfg, weights, b, n_top, temp, LOOP, seed, pos0, **kw)
        _same(got, want)
        assert eager.replays - before == replays[i]
    assert eager.captures == (1 if n_top >= B else 0)


def test_a_replaced_weight_never_replays(eager):
    cfg, _, weights = _model()
    _call(cfg, weights, 4, 2 * B, 1.0, kdec.KERNELS, 1, 0)
    weights["mlp"]["w_h"] = weights["mlp"]["w_h"] * 1.5
    got = _call(cfg, weights, 4, 2 * B, 1.0, kdec.KERNELS, 1, 0)
    _same(got, _call(cfg, weights, 4, 2 * B, 1.0, LOOP, 1, 0))
    assert eager.captures == 2 and len(megagen._GRAPHS) == 2


def test_the_cache_is_bounded_and_drops_dead_graphs(eager):
    cfg, params, weights = _model()
    for lanes in range(1, megagen.GRAPHS_KEPT + 3):
        _call(cfg, weights, lanes, B, 0.0, kdec.KERNELS, 0, 0)
    assert len(megagen._GRAPHS) == megagen.GRAPHS_KEPT
    assert [k[1][0] for k in megagen._GRAPHS] == list(
        range(3, megagen.GRAPHS_KEPT + 3))
    key = next(reversed(megagen._GRAPHS))
    assert megagen._cached(key) is not None
    for g in megagen._GRAPHS.values():
        g.args = None        # the stand-in's hold; a CUDA graph holds none
    del weights, params
    gc.collect()
    assert megagen._cached(key) is None and key not in megagen._GRAPHS


def test_the_span_counts_replayed_top_frames(eager):
    cfg, _, weights = _model()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for n_top in (2 * B + 3, 2 * B + 3, B - 1):
            _call(cfg, weights, 4, n_top, 1.0, kdec.KERNELS, 1, 0)
        _call(cfg, weights, 4, 2 * B, 1.0, LOOP, 1, 0)
    runs = [s for s in profiling.spans() if s.name == "megagen.run"]
    profiling.clear()
    assert [(s.attrs["top_frames"], s.attrs["graphed"]) for s in runs] == [
        (2 * B + 3, B), (2 * B + 3, 2 * B), (B - 1, 0), (2 * B, 0)]

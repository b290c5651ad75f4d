"""Whole generation on the decode kernels: the counterpart of
``samplernn_pase_tpu/ops/pallas/megagen.py:generate_full_pallas`` for GRU
and LSTM tiers of any ``n_rnn``, greedy or sampled, with or without
conditioning (its resident and ``stream_top`` forms compute the same
samples; here every weight is read from L2 or device memory at each use).
The loop (``run``) takes any number of tiers and f1 >= 1, so it is also
the counterpart of the reference's per-frame route (``_xla_generate``
over ``fused_tier_frame_decode`` or the tier step and
``fused_frame_decode``); ``generate_full`` keeps the megakernel's scope.

The TPU megakernel keeps every weight (~55 MB in bf16) resident in one
core's 128 MiB of VMEM for one launch.  The flagship's bf16 weights are
78.4 MB (39.2 M elements, W' included), above the H100's 50 MB L2 and the
~30 MB of shared memory over its 132 SMs, so that design does not carry
over; a single persistent kernel is later work.  Here the loop over top
frames runs on the host and launches the kernels of ``decode.py``:

* per tier-k step (k > 0): K2 (tier input + upper, + the lane's
  conditioning row), then per stacked layer K2 (input gates ``xg``), K2
  (recurrent gates ``hg``, on the chain or beside K1, below) and K3 (GRU),
  or K2 (``xg``), K2 (``hg`` with ``xg`` added) and K6 (LSTM), then K2
  (upsample of the last layer's h, bias added);
* per bottom frame: the counterpart of ``fused_tier_frame_decode``
  (``decode.tier_frame``): the same cell, K2 (upsample rows, ``b_up``
  added per row by K1), then K1 for the f1 samples.

A tier step takes 2 + 3 * n_rnn launches and a bottom frame one more.  A
flagship top frame (2-tier GRU, frame_sizes (16, 4)) takes 29 launches at
n_rnn=1 and 44 at n_rnn=2 (8 for the top tier, 4 x 9 for the bottom
frames); config 2's (3-tier LSTM, (16, 4, 4)) 121 at n_rnn=1 (5 for tier
2, 4 x 5 for tier 1 and 16 x 6 for the bottom frames) and 184 at n_rnn=2.

**The GRU's ``hg`` beside K1** (``offchain``: K2 on CUDA tensors).  A GRU
layer's ``hg = h @ w_hh + b_hh`` for its next step needs only the ``h``
its step left, yet on the chain it waits for the next step's tier input
and ``xg``.  K1 holds 8 clusters of 8, 64 of the 132 SMs at B=128, for
about 180 us a bottom frame.  So each GRU tier's next ``hg`` (every
layer) is launched right after the first K1 that follows its step, and
the next step's K3 reads it: the bottom tier's beside each K1, the upper
tiers' beside the first K1 under them.  Each is the same K2 launch with
the same plan, so levels and states are bit-equal to the chain's, and
the launch counts do not change.  The rules that keep it right and fast:

* K1 residency: K1 launches at most the clusters the card holds at once,
  each walking its tiles, so a K2 that took SMs first would serialise
  K1's tiles.  K1 runs ``griddepcontrol.launch_dependents`` once its
  clusters are up, and each product is launched as a programmatic
  dependent (K2's ``pdl``) of the kernel before it, K1 or the product
  before (``beside_k1``): it starts once K1 is resident or the product
  before has left its SMs, and none waits on K1's grid (none reads what
  K1 writes).  A programmatic dependent completes only once the kernel
  before it has (a product beside K1 ends with K1), so a product launched
  in plain order after one would wait for all of K1.
* The join: an event recorded after K1 and after each product, all
  waited on after the last, so everything launched later waits on K1
  and on each product itself, not on what a programmatic edge implies (a
  capture makes them graph edges).
* Buffers: the caching allocator reasons in stream order, but the
  products run beside a kernel launched before them.  Their outputs are
  allocated before K1 is launched, and nothing is allocated between K1
  and the join, so no output takes a block K1 reads or writes (the
  upsample rows, the window, the rows of the conditioning); the same
  holds inside a capture's pool.
* What stays on the chain: a tier's first step of each ``_frames`` range
  (a call's first top frame, a graph block's, the loop's remainder: its
  ``h`` comes from the host's load or the block's static state, and no
  product is made for a step past the range), LSTM layers (their ``hg``
  takes ``xg`` as K2's ``add``; told apart by the state, ``(h, c)``), and
  the plain versions and CPU tensors, which run nothing beside anything.
  The flagship keeps 4 of a block's 160 ``hg`` on the chain, ``c4_tts``
  2 of 80.

Conditioning adds no launch: the megakernel's two-row select
(``tier_in``, ``megagen.py:196-220``) is K2's epilogue on the tier input,
fed the rows the caller projected once per call (``ext_proj``).  Its
per-lane host noise (``gumbel`` under the reference's ``lane_keys``,
``megagen.py:139-166``) is K1's noise mode 3: each lane draws with its
own key at its own positions (``lane_keys``, ``pos0`` a [B] tensor).

Lower tiers recurse as in the megakernel's ``decode``.  The levels go
into one preallocated int32 buffer ``[B, lookback + n_top*lookback]``
whose first ``lookback`` columns are the seed window, so every tier's
input frame (the last ``span_k`` samples) is a strided view of it and K1
writes its samples straight into it.  No chunking is needed: the buffer
is 8 MB at B=128 and 16,000 samples, Philox noise is drawn inside K1, and
a caller-supplied ``gumbel`` ``[n_bottom, f1, B, q]`` is the caller's
memory.

Launched one by one from Python, a stacked flagship top frame's 44
launches cost an H100 host 1.7-1.9 ms, more than the card's 1.28 ms for
them, so the card waited on the host.  So ``run`` records the
launches of ``BLOCK`` top frames once into a CUDA graph and replays it
(``graph_blocks`` says when): every input that differs between replays
(the window, the states, positions, seed, lane keys and conditioning)
sits in the graph's static buffers, filled with one copy each before a
call's first replay, and the graph's last nodes write the next window,
the final states and the next base position back into them, so blocks
chain on the card.  The launches stay K1, K2, K3 and K6, with the same
arguments and in the same order as on the loop (``_frames`` issues both,
the ``hg`` beside K1, its event join and its programmatic edge
included), so a graphed call's levels and states are bit-equal to the
loop's.  The graphs live in a small cache keyed by the
call's structure (``graph_key``); one whose weight tensors have died never
replays.

Each call of ``run`` is one span, ``megagen.run`` (attrs ``top_frames``,
``lanes``, ``graphed``: the top frames replayed, ``offchain``: the ``hg``
products computed beside K1, ``hg``: all the GRU layers' ``hg``
products; ``utils/profiling.py``),
recorded while a profiler runs: the host's time launching a call's
kernels, and none per launch.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import torch

from samplernn_pase_tpu_torch.ops.kernels.decode import (
    KERNELS, LAUNCHES, PLAIN, CondRows, Ops, decode_state, gemm_bias,
    kernel_lane_keys, model_state, noise_mode, prepare_mlp, prepare_tier,
    tier_cell, tier_gates)
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype
from samplernn_pase_tpu_torch.tree import tree_leaves
from samplernn_pase_tpu_torch.utils.profiling import note, spanned

BLOCK = 16          # top frames a graph replays: 1,024 samples at lookback
                    # 64, the pool's chunk
GRAPHS_KEPT = 8     # captured graphs kept, the least recently used dropped
_GRAPHS: OrderedDict = OrderedDict()       # graph_key -> _Graph


def prepare(tiers, mlp, dtype, ops: Ops = KERNELS) -> dict:
    """Kernel-form weights for every tier (bottom first) and the MLP."""
    f1 = tiers[0]["b_up"].shape[0]
    return {"tiers": [prepare_tier(t, dtype) for t in tiers],
            "mlp": prepare_mlp(mlp, dtype, f1, ops)}


def graph_blocks(n_top: int, device, ops: Ops, gumbel, cond) -> int:
    """The blocks of ``BLOCK`` top frames of a call that ``run`` replays as
    a CUDA graph; the rest of its top frames go through the launch loop.
    None for the calls ``run``'s docstring lists, and for calls shorter
    than one block."""
    if (ops is not KERNELS or gumbel is not None or device.type != "cuda"
            or (cond is not None and n_top > BLOCK)):
        return 0
    return n_top // BLOCK


def graph_key(weights, window, temperature, q_levels: int, mode: int,
              cond) -> tuple:
    """The structure a graph records: device and lanes, ``BLOCK``, every
    weight's pointer, shape, strides and dtype (so tier and layer shapes
    too), ``q_levels``, temperature, noise mode and, conditioned, the
    rate and each tier's row count."""
    leaves = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                   for t in tree_leaves(weights))
    rows = None if cond is None else (
        cond[2], tuple(tuple(e.shape) for e in cond[0]))
    return (window.device, tuple(window.shape), BLOCK, leaves, q_levels,
            float(temperature or 0.0), mode, rows)


def offchain(ops: Ops, device) -> bool:
    """Whether ``run`` computes the GRU tiers' next ``hg`` beside K1 (the
    module docstring): with K2 itself (``ops.gemm`` is ``gemm_bias``) on
    CUDA tensors.  The plain versions and CPU tensors run nothing beside
    anything, so they keep every ``hg`` on the chain."""
    return ops.gemm is gemm_bias and device.type == "cuda"


def beside_k1(ops: Ops, products, joins=None) -> list:
    """Launch ``products``, each ``(h, layer, out)``, right after K1 on the
    current stream: ``out = h @ layer["w_hh"] + layer["b_hh"]`` by
    ``ops.gemm``, each a programmatic dependent of the kernel before it
    (K1, then the product before), so that it starts once K1's clusters
    are up or the product before has left its SMs, and waits on no grid.
    ``joins``: a list of CUDA events, grown as needed, for the join: one
    recorded after K1 and after each product, all waited on at the end,
    so that what follows waits on each of them itself (a programmatic
    dependent is complete only once the kernel before it is: on the
    H100 a product beside K1 ends with K1); None on the CPU.  The stream
    is the products' device's current one, K1's.  Returns the products'
    outputs."""
    stream = (None if joins is None or not products
              else torch.cuda.current_stream(products[0][0].device))

    def join(i):
        if len(joins) <= i:
            joins.append(torch.cuda.Event())
        joins[i].record(stream)

    if stream is not None:
        join(0)
    got = []
    for i, (h, lw, out) in enumerate(products):
        got.append(ops.gemm(h, lw["w_hh"], lw["b_hh"], out=out, pdl=True))
        if stream is not None:
            join(i + 1)
    if stream is not None:
        for e in joins[:len(products) + 1]:
            stream.wait_event(e)
    return got


def _frames(tiers, mw, buf, h, top, temperature, q_levels, ops, seed,
            pos_off, lane_pos, tier_cond, lane_keys, gumbel=None,
            beside=False):
    """Launch the kernels of top frames ``top`` (a range): levels into
    ``buf`` [B, lookback + ...], whose first ``lookback`` columns hold the
    window before frame 0, and the per-tier decode states of the list
    ``h`` replaced as they advance.  With ``beside`` (``offchain``), each
    GRU tier's next ``hg`` within ``top`` is computed beside the first K1
    after its step.  Returns (the ``hg`` products computed beside K1, all
    the GRU tiers' ``hg`` products)."""
    frame_sizes = [t["b_up"].shape[0] for t in tiers]
    spans = []
    acc = 1
    for f in frame_sizes:
        acc *= f
        spans.append(acc)
    lookback = spans[-1]
    f1 = frame_sizes[0]
    end = lookback * top.stop        # past the range's last sample
    ahead = [None] * len(tiers)      # tier k's hg for its next step
    due = []                         # tiers whose next hg goes beside K1
    counts = [0, 0]
    joins = [] if beside and buf.is_cuda else None

    def cell(k, frame, upper, p):
        gru = len(h[k][0]) == 1
        if gru:
            counts[0] += 0 if ahead[k] is None else len(h[k])
            counts[1] += len(h[k])
        h[k] = tier_cell(tiers[k], frame, upper, h[k], q_levels, ops,
                         tier_cond[k], p, ahead[k])
        ahead[k] = None
        if beside and gru and p + spans[k] < end:
            due.append(k)

    def decode(k, upper, p):
        """Tier k's frame starting at generated sample p."""
        start = lookback + p
        frame = buf[:, start - spans[k]:start]
        cell(k, frame, upper, p)
        if k > 0:
            last = h[k][-1][0]          # the last layer's h
            cond = ops.gemm(last, tiers[k]["w_up"], tiers[k]["b_up_flat"])
            hdim = last.shape[1]
            for j in range(frame_sizes[k]):
                decode(k - 1, cond[:, j * hdim:(j + 1) * hdim],
                       p + j * spans[k - 1])
            return
        # the bottom frame (decode.tier_frame): the upsample rows, then K1;
        # the outputs of the products beside it are allocated first, so
        # that none takes a block K1 reads or writes
        rows = ops.gemm(h[0][-1][0], tiers[0]["w_up"])
        products = [(x[0], lw, x[0].new_empty((x[0].shape[0],
                                               lw["w_hh"].shape[1])))
                    for j in due for x, lw in zip(h[j], tiers[j]["layers"])]
        noise = None if gumbel is None else gumbel[p // f1]
        ops.frame(frame, rows, tiers[0]["b_up"], mw, temperature, noise,
                  seed, pos_off + p, buf[:, start:start + f1], lane_keys,
                  lane_pos)
        if due:
            got = beside_k1(ops, products, joins)
            for j in due:
                ahead[j], got = got[:len(h[j])], got[len(h[j]):]
            due.clear()

    for t in top:
        decode(len(tiers) - 1, None, t * lookback)
    return tuple(counts)


class _Graph:
    """A captured block of ``BLOCK`` top frames and its static buffers:
    ``buf`` (the window, then the block's levels), the model-layout
    ``states``, ``pos`` (each lane's noise position of the block's first
    sample), ``seed``, ``keys`` (mode 3) and ``cond`` (the rows and
    phase, conditioned)."""

    def __init__(self, weights, window, states, cond, mode):
        dev = window.device
        b, lookback = window.shape
        self.refs = [weakref.ref(t) for t in tree_leaves(weights)]
        self.buf = torch.empty((b, (1 + BLOCK) * lookback),
                               dtype=torch.int32, device=dev)
        self.states = [torch.empty(s.shape, dtype=torch.float32, device=dev)
                       for s in states]
        self.pos = torch.zeros(b, dtype=torch.int64, device=dev)
        self.seed = torch.zeros(1, dtype=torch.int64, device=dev)
        self.keys = (torch.zeros((b, 2), dtype=torch.int32, device=dev)
                     if mode == 3 else None)
        self.cond = None if cond is None else CondRows(
            tuple(torch.empty(e.shape, dtype=torch.float32, device=dev)
                  for e in cond[0]),
            torch.empty(b, dtype=torch.int32, device=dev), cond[2])
        self.graph = None
        self.launches = {}
        self.counts = (0, 0)     # a replay's hg: beside K1, all

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def block(self, tiers, mw, temperature, q_levels):
        """What the graph records: one block's launches on the static
        buffers, then the copies that chain the next block (the window
        from the block's last ``lookback`` levels, the final states, the
        base position advanced by the block).  Returns ``_frames``'s
        counts."""
        lookback = self.buf.shape[1] // (1 + BLOCK)
        h = [decode_state(s, t["layers"]) for s, t in zip(self.states, tiers)]
        tier_cond = ([None] * len(tiers) if self.cond is None else
                     [CondRows(e, self.cond.phase, self.cond.rate)
                      for e in self.cond.ext])
        counts = _frames(tiers, mw, self.buf, h, range(BLOCK), temperature,
                         q_levels, KERNELS, self.seed, 0, self.pos, tier_cond,
                         self.keys,
                         beside=offchain(KERNELS, self.buf.device))
        self.buf[:, :lookback].copy_(self.buf[:, -lookback:])
        for s, x in zip(self.states, h):
            s.copy_(model_state(x))
        self.pos.add_(BLOCK * lookback)
        return counts

    def capture(self, tiers, mw, temperature, q_levels):
        """Record ``block`` on the stream the wrappers launch on (the
        capture's); ``launches`` keeps what the capture counted in
        ``LAUNCHES`` (a replay adds it), which is left as it was, and
        ``counts`` the block's ``hg`` products."""
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.counts = self.block(tiers, mw, temperature, q_levels)
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        LAUNCHES.update(before)

    def load(self, window, states, pos0, seed, lane_keys, cond):
        """One copy into each static buffer: the window before the first
        replayed frame, the states, positions (``pos0``: an int or a [B]
        int64 tensor), the seed's 64 bits, the keys and the rows."""
        lookback = window.shape[1]
        self.buf[:, :lookback].copy_(window)
        for dst, src in zip(self.states, states):
            dst.copy_(src)
        if isinstance(pos0, torch.Tensor):
            self.pos.copy_(pos0)
        else:
            self.pos.fill_(pos0)
        bits = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.seed.fill_(bits - (1 << 64) if bits >> 63 else bits)
        if self.keys is not None:
            self.keys.copy_(lane_keys)
        if self.cond is not None:
            for dst, src in zip(self.cond.ext, cond[0]):
                dst.copy_(src)
            self.cond.phase.copy_(cond[1])

    def replay(self):
        self.graph.replay()
        for k, v in self.launches.items():
            LAUNCHES[k] += v


def _cached(key):
    """The live graph under ``key``, or None (a dead one is dropped)."""
    g = _GRAPHS.get(key)
    if g is not None and not g.alive():
        del _GRAPHS[key]
        g = None
    if g is not None:
        _GRAPHS.move_to_end(key)
    return g


def _keep(key, g):
    for k in [k for k, v in _GRAPHS.items() if not v.alive()]:
        del _GRAPHS[k]
    while len(_GRAPHS) >= GRAPHS_KEPT:
        _GRAPHS.popitem(last=False)
    _GRAPHS[key] = g


@spanned("megagen.run")
def run(weights, window, states, temperature, n_top, q_levels,
        ops: Ops = KERNELS, seed: int = 0, pos0=0, gumbel=None,
        cond: tuple | None = None, lane_keys=None):
    """Generate ``n_top`` top frames on prepared weights.

    window [B, lookback] int32; states: per-tier model-layout states,
    [n_rnn, B, H] (GRU) or [n_rnn, 2, B, H] (LSTM) float32; any number of
    tiers.  Returns (levels [B, n_top*lookback] int32, final states, same
    layout).
    ``pos0`` is the noise position of the first sample, an int or a [B]
    int64 tensor (one per lane); noise is Philox keyed by ``seed``, or by
    each lane's ``lane_keys`` [B, 2]; ``gumbel`` [n_bottom, f1, B, q]
    float32 replaces Philox.  ``cond``: (ext_proj, cond_phase, cond_rate)
    with ext_proj a per-tier tuple of [R, B, H] float32 rows, cond_phase
    [B] int32, or None.

    On K2 and CUDA tensors (``offchain``) each GRU tier's next ``hg``
    runs beside K1 (the module docstring), on both routes.  Blocks of
    ``BLOCK`` top frames replay a CUDA graph (``graph_blocks``), the
    remainder, ``n_top % BLOCK``, takes the launch loop.  The first
    call of a structure (``graph_key``) runs its first block on the loop,
    so that every launcher's first use (attributes, occupancy, tensor
    maps) lies outside a capture, then captures it.  These calls keep the
    loop throughout:

    * a caller-supplied ``gumbel`` (mode 1): a block of the caller's
      memory per bottom frame, as large as the levels' whole noise, made
      for holding the loop against the reference, not for speed;
    * ``ops`` other than ``KERNELS`` (``PLAIN``): the plain versions are
      what the kernels are held against, not a path to speed up (and
      ``Ops(*KERNELS)`` runs the same kernels on the loop);
    * CPU tensors: no CUDA graph;
    * a conditioned call longer than one block: K2 takes the rows' base
      (``pos // cond_rate``) and the phase step (``pos % cond_rate``) as
      host ints that move from block to block, and ``BLOCK`` top frames
      (1,024 samples at lookback 64) are not a multiple of ``cond_rate``
      (160 in config 4), so no two blocks of a call launch alike.  A
      conditioned call of one block, the pool's chunk, replays."""
    tiers = weights["tiers"]
    mw = weights["mlp"]
    frame_sizes = [t["b_up"].shape[0] for t in tiers]
    lookback = 1
    for f in frame_sizes:
        lookback *= f
    f1 = frame_sizes[0]
    b = window.shape[0]
    note(top_frames=n_top, lanes=b)
    if window.shape != (b, lookback):
        raise ValueError(f"window {tuple(window.shape)} != ({b}, {lookback})")
    if gumbel is not None and gumbel.shape[0] != n_top * lookback // f1:
        raise ValueError(f"gumbel has {gumbel.shape[0]} frames, expected "
                         f"{n_top * lookback // f1}")
    buf = torch.empty((b, lookback + n_top * lookback), dtype=torch.int32,
                      device=window.device)
    buf[:, :lookback] = window
    if len(states) != len(tiers):
        raise ValueError(f"{len(states)} states for {len(tiers)} tiers")
    h = [decode_state(s, t["layers"]) for s, t in zip(states, tiers)]
    tier_cond = [None] * len(tiers)
    if cond is not None:
        ext_proj, phase, rate = cond
        if len(ext_proj) != len(tiers):
            raise ValueError(f"{len(ext_proj)} ext_proj for {len(tiers)} "
                             "tiers")
        tier_cond = [CondRows(e, phase, rate) for e in ext_proj]
    if lane_keys is not None:
        lane_keys = kernel_lane_keys(lane_keys, window.device)
    lane_pos = pos0 if isinstance(pos0, torch.Tensor) else None
    pos_off = 0 if lane_pos is not None else int(pos0)
    loop = dict(temperature=temperature, q_levels=q_levels, ops=ops,
                seed=seed, pos_off=pos_off, lane_pos=lane_pos,
                tier_cond=tier_cond, lane_keys=lane_keys, gumbel=gumbel,
                beside=offchain(ops, window.device))

    done = replayed = 0
    counts = [0, 0]         # the call's hg: beside K1, all

    def add(c):
        counts[0] += c[0]
        counts[1] += c[1]

    blocks = graph_blocks(n_top, window.device, ops, gumbel, cond)
    if blocks:
        mode = noise_mode(temperature, gumbel, lane_keys)
        key = graph_key(weights, window, temperature, q_levels, mode, cond)
        g = _cached(key)
        if g is None:
            add(_frames(tiers, mw, buf, h, range(BLOCK), **loop))
            g = _Graph(weights, window, states, cond, mode)
            g.capture(tiers, mw, temperature, q_levels)
            _keep(key, g)
            done, blocks = BLOCK, blocks - 1
        if blocks:
            at = done * lookback
            g.load(buf[:, at:at + lookback],
                   states if not done else [model_state(x) for x in h],
                   pos0 + at if lane_pos is not None else pos_off + at,
                   seed, lane_keys, cond)
            width = BLOCK * lookback
            for _ in range(blocks):
                g.replay()
                add(g.counts)
                at = lookback + done * lookback
                buf[:, at:at + width].copy_(g.buf[:, lookback:])
                done += BLOCK
                replayed += BLOCK
            h = [decode_state(s, t["layers"])
                 for s, t in zip(g.states, tiers)]
    add(_frames(tiers, mw, buf, h, range(done, n_top), **loop))
    note(graphed=replayed, offchain=counts[0], hg=counts[1])
    return buf[:, lookback:], tuple(model_state(x) for x in h)


def _check_scope(tiers, rnn_type):
    """The reference megakernel's scope (``generate._full_kernel_eligible``):
    GRU or LSTM tiers of any n_rnn, 2 or 3 tiers, f1 >= 2 (its pipelined
    window split needs two slots).  ``run`` decodes the rest, as the
    reference's per-frame route does."""
    gates = {"gru": 3, "lstm": 4}.get(rnn_type)
    if gates is None:
        raise NotImplementedError(f"generate_full takes GRU or LSTM tiers, "
                                  f"not {rnn_type!r}")
    for t in tiers:
        for layer in t["rnn"]:
            w = layer["w_hh"]
            if tier_gates(w) != gates:
                raise ValueError(f"rnn_type={rnn_type!r} but a tier's w_hh "
                                 f"is {tuple(w.shape)}")
    if len(tiers) not in (2, 3):
        raise ValueError(
            f"generate_full takes 2 or 3 tiers, as the megakernel, got "
            f"{len(tiers)}; generate.generate_levels decodes any count")
    if tiers[0]["b_up"].shape[0] < 2:
        raise ValueError(
            "generate_full needs frame_sizes[0] >= 2, as the megakernel; "
            "generate.generate_levels decodes f1=1")


def generate_full(window, states, temperature, tiers, mlp, *, n_top: int,
                  q_levels: int = 256, rnn_type: str = "gru",
                  weights_dtype="bfloat16", seed: int = 0, pos0=0,
                  gumbel=None, cond_rate: int = 0, ext_proj=None,
                  cond_phase=None, lane_keys=None, ops: Ops = KERNELS):
    """Counterpart of ``generate_full_pallas``, in the scope of the
    megakernel route (``_check_scope``).

    window [B, lookback] int32 seed context; states: tuple of per-tier
    model-layout states, [n_rnn, B, H] (GRU) or [n_rnn, 2, B, H] (LSTM)
    float32;
    tiers: tier params bottom -> top; temperature 0 = greedy.  Sampling
    draws Philox noise from ``seed``, or from each lane's ``lane_keys``
    [B, 2], at positions ``pos0 ..`` (an int, or a [B] tensor of per-lane
    first positions), or reads ``gumbel`` [n_bottom, f1, B, q] (the Pallas
    kernel's host-noise input).  Conditioning as the Pallas kernel's:
    ``cond_rate``, ``ext_proj`` (per tier [R, B, H] float32 projected rows,
    each lane's from its own row origin) and ``cond_phase`` [B] (each
    lane's first position modulo ``cond_rate``).  Returns
    (levels [B, n_top*lookback] int32 -- the Pallas kernel's
    [n_top, B, lookback] blocks laid end to end per lane -- and the final
    states)."""
    _check_scope(tiers, rnn_type)
    dt = torch_dtype(weights_dtype)
    weights = prepare(tiers, mlp, dt, ops)
    cond = None
    if cond_rate:
        dev = window.device
        cond = (tuple(torch.as_tensor(e, dtype=torch.float32, device=dev)
                      for e in ext_proj),
                torch.as_tensor(cond_phase, device=dev).to(
                    torch.int32).reshape(-1).contiguous(), int(cond_rate))
    return run(weights, window.to(torch.int32), states, temperature, n_top,
               q_levels, ops, seed, pos0, gumbel, cond, lane_keys)


def generate_full_plain(window, states, temperature, tiers, mlp, **kw):
    """``generate_full`` through the plain versions of K1, K2, K3 and K6
    (the same arithmetic in PyTorch), to hold the kernel path against on
    the card."""
    return generate_full(window, states, temperature, tiers, mlp,
                         ops=PLAIN, **kw)

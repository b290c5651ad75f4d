"""The whole-sequence RNNs of a training step: K4 ``gru_sequence`` and K5
``lstm_sequence``, forward and backward, their plain PyTorch versions, and
the counterparts of ``samplernn_pase_tpu/ops/pallas/rnn_train.py``'s
``gru_sequence`` and ``lstm_sequence``.

GRU math (gates r, z, n in the cuDNN order, as ``rnn_cells.gru_step``):
    xg = round(x_t) @ Wih + bih ; hg = round(h_{t-1}) @ Whh + bhh
    r = s(xr + hr) ; z = s(xz + hz) ; n = tanh(xn + r * hn)
    h_t = (1 - z) * n + z * h_{t-1}
LSTM math (gates i, f, g, o, as ``rnn_cells.lstm_step``):
    g = xg + hg ; c_t = s(g_f) * c_{t-1} + s(g_i) * tanh(g_g)
    h_t = s(g_o) * tanh(c_t)
``round`` is the cast to the weights dtype; products accumulate in
float32; biases, gates and the carried ``h`` and ``c`` are float32.
``h_seq`` (and the LSTM's ``c_seq``) are stored in the weights dtype and
``h_seq`` is handed back as float32; the final state is the float32
carry.  The backward passes follow the reference's VJPs: ``dh_seq`` is
rounded to the weights dtype; ``h_{t-1}`` is the stored (rounded)
``h_seq[t-1]``, or the float32 ``h0`` at t=0; the LSTM reads ``c_{t-1}``
and ``c_t`` back from the rounded ``c_seq`` (``c0`` float32 at t=0), so
``tanh(c_t)`` and ``dc * c_{t-1}`` see rounded values; the gate gradients
are rounded before the ``dx``, ``dW`` and carry products, while the bias
sums (and the GRU's ``g*z`` term, the LSTM's ``dc_{t-1} = dc * f``) use
them unrounded; ``dx`` is stored in the weights dtype and cast to ``x``'s
dtype; ``dh0``, ``dc0``, ``dW`` and ``db`` are float32.

The kernels (``csrc/gru_sequence.cu``, ``csrc/lstm_sequence.cu``) keep
gate pre-activations of the forward pass as residuals, so the backward
pass does not recompute them: K4 keeps ``xg`` and ``hg`` ([N, B, 3H]
float32 each), K5 the one sum ``g`` ([N, B, 4H] float32).  The values
equal the reference's recompute, since ``hbuf[t] = round(h_{t-1})`` is
what both products read.

Eligibility on the H100 (``kernel_scope_error``): a GRU or an LSTM;
``dim % 8 == 0`` (a block owns a multiple of 8 hidden units and reads rows
in 16-byte vectors); and a chain whose blocks all fit on the card at once
with their Whh slices in shared memory, as the library answers for the
card at hand (``srnn_gru_seq_fits``, ``srnn_lstm_seq_fits``).  bf16: the
plan of ``chain_plan`` (8- or 16-unit blocks, one or two per SM), which
holds every width to 1,664 (GRU) and 1,152 (LSTM) and beyond; float32:
dim/8 blocks of the FMA chains, one per SM, so dim <= 1,056.  Device
memory holds the residuals: 24*N*B*H bytes for K4's xg and hg, 16*N*B*H
for K5's g, plus the stored sequences in the weights dtype.

Each wrapper runs its plain version on CPU tensors (how the CPU tests run)
and, on CUDA tensors, launches its kernel or raises; it adds one to its
count in ``LAUNCHES`` per launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from samplernn_pase_tpu_torch.ops.kernels import _build
from samplernn_pase_tpu_torch.ops.kernels.decode import (
    _check, _on_cpu, _stream)
from samplernn_pase_tpu_torch.ops.matmul import torch_dtype

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"gru_sequence_fwd": 0, "gru_sequence_bwd": 0,
            "lstm_sequence_fwd": 0, "lstm_sequence_bwd": 0}

UNITS = 8                       # hidden units per block of the f32 chains

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (library, symbol, argument types)
_SIGNATURES = {
    "gru_sequence_fwd": ("gru_sequence", "srnn_gru_seq_fwd",
                         [_P] * 11 + [_I] * 4 + [_P, _P]),
    "gru_sequence_bwd": ("gru_sequence", "srnn_gru_seq_bwd",
                         [_P] * 19 + [_I] * 4 + [_P, _P]),
    "gru_fits": ("gru_sequence", "srnn_gru_seq_fits", [_I, _I, _P]),
    "lstm_sequence_fwd": ("lstm_sequence", "srnn_lstm_seq_fwd",
                          [_P] * 13 + [_I] * 4 + [_P, _P]),
    "lstm_sequence_bwd": ("lstm_sequence", "srnn_lstm_seq_bwd",
                          [_P] * 20 + [_I] * 4 + [_P, _P]),
    "lstm_fits": ("lstm_sequence", "srnn_lstm_seq_fits", [_I, _I, _P]),
}

# The bf16 chains (csrc/seq_common.cuh, namespace tc), mirrored here so
# that their plan can be checked on the CPU.
SMEM_MAX = 231424               # dynamic shared memory per block: the
                                # H100's 227 KB less 1 KB of static
SM_SMEM = 233472                # shared memory per SM (228 KB)
BLOCK_SMEM = 1024 + 256         # per block beside its dynamic shared memory:
                                # the SM's reservation and the mbarriers
SMS = 132                       # the H100's SMs
BOX = 64 * 128                  # bytes of a 64-row x 64-column bf16 box
MAX_STAGES = 16                 # ring slots
FLAG_STRIDE = 32                # ints between two blocks' flags: a line
MIN_STAGES = 4                  # single-chunk slots: more than the 2
                                # in flight
GATES = {"gru": 3, "lstm": 4}


class ChainPlan(NamedTuple):
    """How a bf16 chain runs: blocks of ``units`` hidden units (8 or 16)
    for ``rows`` rows each, multiplied ``64 * warpgroups`` rows at a time
    (one wgmma warpgroup per 64 rows); ``dim / units`` unit groups times
    ``ceil(batch / rows)`` row groups make ``blocks``; the staged rows go
    through a ring of ``stages`` slots of ``chunks`` 64-column boxes (one
    TMA copy each: 8, or 1 where the width is not a multiple of 64 or two
    slots of 8 would not fit); ``smem`` bytes of shared memory per block
    (the larger of the two directions)."""
    units: int
    warpgroups: int
    rows: int
    stages: int
    chunks: int
    smem: int
    blocks: int


def _chain_smem(cell: str, dim: int, units: int, warpgroups: int,
                stages: int, chunks: int = 1) -> int:
    """Dynamic shared memory of a chain block (``tc::smem_bytes``): 1 KB of
    alignment, the Whh slice as wgmma's B operand in 64-column panels
    (forward: gates * units rows of dim; backward: units rows of gates *
    dim; panels rounded up to whole slots), the ring."""
    g = GATES[cell]

    def panels(k):
        return -(-(-(-k // 64)) // chunks) * chunks

    ws = max(panels(dim) * g * units * 128, panels(g * dim) * units * 128)
    return 1024 + ws + stages * chunks * warpgroups * BOX


def chain_plan(cell: str, dim: int, batch: int,
               w_dtype=torch.bfloat16) -> ChainPlan | None:
    """The plan of K4's (``cell="gru"``) or K5's (``"lstm"``) bf16 chains
    for width ``dim`` and batch ``batch``: a pure function of those (never
    of the sequence length), None for float32 weights (the FMA chains), or
    ValueError where no plan fits the card.

    Each step every block reads all ``rows`` rows of h_{t-1} (or dG_t)
    from L2, so the bytes read per step are ``dim / units * batch`` rows:
    above 64 rows, 16-unit blocks of 64 rows each (row groups) halve them
    where all blocks stay resident (the flagship: 64 x 2 = 128 blocks);
    else 8-unit blocks over all rows, one or two warpgroups; 16-unit blocks
    where dim / 8 blocks would not all be resident; one warpgroup, then
    two blocks per SM (a smaller ring), where nothing else fits.  Ring
    slots of eight chunks (one TMA copy per 8 x 64 columns: on the H100 a
    copy costs the issuing thread about 0.4 us whatever its size,
    scripts/seq_trace.py) where the width is a multiple of 64 and two
    such slots fit, else single chunks; as many slots as the shared memory
    holds, up to ``MAX_STAGES``.  No clusters: pairs of blocks taking the
    copies in turn and multicasting each to both (half the L2 reads) ran
    5-25% slower on the H100 (PERF.md)."""
    if w_dtype != torch.bfloat16:
        return None
    if cell not in GATES or dim < 8 or dim % 8 or batch < 1:
        raise ValueError(f"chain_plan: {cell}, dim={dim}, batch={batch}")
    wg = 1 if batch <= 64 else 2
    candidates = [(16, 1, 64, 1)] if batch > 64 else []
    for per_sm in (1, 2):
        for units, wgs in ((8, wg), (16, wg), (8, 1), (16, 1)):
            candidates.append((units, wgs, -(-batch // (64 * wgs)) * 64 * wgs,
                               per_sm))
    for units, wgs, rws, per_sm in candidates:
        if dim % units:
            continue
        blocks = dim // units * -(-batch // rws)
        if blocks > SMS * per_sm:
            continue
        room = min(SMEM_MAX, SM_SMEM // per_sm - BLOCK_SMEM)
        for chunks, least in ((8, 2), (1, MIN_STAGES)):
            if chunks > 1 and dim % 64:
                continue
            fixed = _chain_smem(cell, dim, units, wgs, 0, chunks)
            stages = min(MAX_STAGES,
                         (room - fixed) // (chunks * wgs * BOX))
            if stages >= least:
                return ChainPlan(units, wgs, rws, stages, chunks,
                                 _chain_smem(cell, dim, units, wgs, stages,
                                             chunks), blocks)
    raise ValueError(f"chain_plan: no plan holds {cell} dim={dim} on the "
                     "card")


def _plan_args(plan):
    """The plan as the library takes it: int[5] (units, warpgroups, rows,
    stages, chunks), zeros for the float32 chains."""
    return (ctypes.c_int * 5)(*(plan[:5] if plan else (0,) * 5))


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name):
    return _build.function(*_SIGNATURES[name])


@functools.lru_cache(maxsize=None)
def _fits(rnn_type: str, dim: int, w_bf16: int, index: int) -> int:
    """``srnn_gru_seq_fits`` or ``srnn_lstm_seq_fits`` on CUDA device
    ``index``, asked once per cell, width, weights dtype and device; bf16
    for the plan of one row group (every batch has a plan of no more
    blocks)."""
    plan = chain_plan(rnn_type, dim, 1) if w_bf16 else None
    args = _plan_args(plan)
    with torch.cuda.device(index):
        return _fn(f"{rnn_type}_fits")(dim, w_bf16, ctypes.addressof(args))


def kernel_scope_error(rnn_type: str, dim: int, weights_dtype,
                       device) -> str | None:
    """Why the sequence kernels cannot run a tier of this cell and width
    on ``device`` (a CUDA device: the library is asked), or None.  The
    training route asks this once per tier; a launch the card cannot
    hold fails in the library instead of deadlocking."""
    if rnn_type not in ("gru", "lstm"):
        return f"no training kernel for rnn_type={rnn_type}"
    if dim % UNITS:
        return f"dim {dim} is not a multiple of {UNITS}"
    wt = torch_dtype(weights_dtype)
    if wt not in (torch.float32, torch.bfloat16):
        return f"no sequence kernel for weights dtype {wt}"
    if wt == torch.bfloat16:
        try:
            chain_plan(rnn_type, dim, 1)
        except ValueError:
            return (f"dim {dim} needs more co-resident blocks or shared "
                    "memory than the card holds")
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    fits = _fits(rnn_type, dim, int(wt == torch.bfloat16), index)
    if fits == 1:
        return f"dim {dim} needs more shared memory than a block has"
    if fits == 2:
        return (f"dim {dim} needs {dim // UNITS} co-resident blocks, more "
                "than the card holds")
    if fits:
        raise RuntimeError(f"srnn_{rnn_type}_seq_fits: CUDA error {-fits}")
    return None


def _launch(name, *args):
    err = _fn(name)(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _scratch(cell, hdim, b, wt, dev, plan, bwd=False):
    """A launch's plan arguments, flags (one int32 line per block, zero) and,
    backward, the row groups' bias partials (pointers, 0 for float32)."""
    if wt != torch.bfloat16:
        return _plan_args(None), None, None
    plan = plan or chain_plan(cell, hdim, b, wt)
    groups = -(-b // plan.rows)
    flags = torch.zeros(hdim // plan.units * groups * FLAG_STRIDE,
                        dtype=torch.int32, device=dev)
    bpart = (torch.empty(groups * 4 * hdim, dtype=torch.float32, device=dev)
             if bwd else None)
    return _plan_args(plan), flags, bpart


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _weights_dtype(weights_dtype) -> torch.dtype:
    wt = torch_dtype(weights_dtype)
    if wt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sequence kernels: weights dtype {wt}")
    return wt


def _gates(xg, hg, h_prev, hdim):
    r = torch.sigmoid(xg[:, :hdim] + hg[:, :hdim])
    z = torch.sigmoid(xg[:, hdim:2 * hdim] + hg[:, hdim:2 * hdim])
    hn = hg[:, 2 * hdim:]
    n = torch.tanh(xg[:, 2 * hdim:] + r * hn)
    return r, z, n, hn


# ------------------------------------------------------------ forward --

def gru_sequence_fwd_plain(x, h0, wih, bih, whh, bhh,
                           weights_dtype="bfloat16"):
    """Plain version of the forward kernel.  x [N, B, H]; h0 [B, H];
    wih/whh [H, 3H]; biases [3H].  Returns (hbuf [N+1, B, H] in the
    weights dtype with hbuf[0] = round(h0) and hbuf[t+1] = round(h_t),
    h_fin [B, H] float32, xg and hg [N, B, 3H] float32)."""
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    w_hh = whh.to(wt).to(f32)
    xg = (torch.matmul(x.to(wt).to(f32).reshape(n * b, hdim),
                       wih.to(wt).to(f32))
          + bih.to(f32).reshape(-1)).reshape(n, b, 3 * hdim)
    hbuf = torch.empty((n + 1, b, hdim), dtype=wt, device=x.device)
    hbuf[0] = h0.to(wt)
    hg = torch.empty_like(xg)
    h = h0.to(f32)
    for t in range(n):
        hg[t] = torch.matmul(hbuf[t].to(f32), w_hh) + bhh.to(f32).reshape(-1)
        _, z, nn, _ = _gates(xg[t], hg[t], h, hdim)
        h = (1.0 - z) * nn + z * h
        hbuf[t + 1] = h.to(wt)
    return hbuf, h, xg, hg


def gru_sequence_fwd(x, h0, wih, bih, whh, bhh, weights_dtype="bfloat16",
                     plan=None):
    """K4 forward: the kernel on CUDA tensors, its plain version on CPU
    tensors; arguments and results as ``gru_sequence_fwd_plain``.
    ``plan``: the bf16 chain's, ``chain_plan`` when None (another is for
    timing sweeps)."""
    if _on_cpu(x, h0, wih, bih, whh, bhh):
        return gru_sequence_fwd_plain(x, h0, wih, bih, whh, bhh,
                                      weights_dtype)
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    xq = x.to(wt).contiguous()
    w_ih, w_hh = wih.to(wt).contiguous(), whh.to(wt).contiguous()
    b_ih = bih.to(f32).reshape(-1).contiguous()
    b_hh = bhh.to(f32).reshape(-1).contiguous()
    h0f = h0.to(f32).contiguous()
    _check(w_ih, "wih", (wt,), (hdim, 3 * hdim))
    _check(w_hh, "whh", (wt,), (hdim, 3 * hdim))
    _check(b_ih, "bih", (f32,), (3 * hdim,))
    _check(b_hh, "bhh", (f32,), (3 * hdim,))
    _check(h0f, "h0", (f32,), (b, hdim))
    dev = x.device
    xg = torch.empty((n, b, 3 * hdim), dtype=f32, device=dev)
    hg = torch.empty_like(xg)
    hbuf = torch.empty((n + 1, b, hdim), dtype=wt, device=dev)
    hfin = torch.empty((b, hdim), dtype=f32, device=dev)
    pa, flags, _ = _scratch("gru", hdim, b, wt, dev, plan)
    _launch("gru_sequence_fwd", xq.data_ptr(), h0f.data_ptr(),
            w_ih.data_ptr(), b_ih.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), xg.data_ptr(), hbuf.data_ptr(), hg.data_ptr(),
            hfin.data_ptr(), _ptr(flags), n, b, hdim,
            int(wt == torch.bfloat16), ctypes.addressof(pa), _stream(x))
    return hbuf, hfin, xg, hg


# ----------------------------------------------------------- backward --

def gru_sequence_bwd_plain(x, h0, wih, whh, hbuf, xg, hg, dh_seq, dh_fin,
                           weights_dtype="bfloat16"):
    """Plain version of the backward kernel.  x, h0, wih, whh as the
    forward; hbuf, xg, hg its residuals; dh_seq [N, B, H]; dh_fin [B, H].
    Returns (dx [N, B, H] in the weights dtype, dh0 [B, H], dwih [H, 3H],
    dbih [3H], dwhh [H, 3H], dbhh [3H], all float32 but dx)."""
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    w_hh = whh.to(wt).to(f32)
    dhs = dh_seq.to(wt)
    d_xg = torch.empty((n, b, 3 * hdim), dtype=wt, device=x.device)
    d_hg = torch.empty_like(d_xg)
    dbih = torch.zeros(3 * hdim, dtype=f32, device=x.device)
    dbhh = torch.zeros_like(dbih)
    carry = dh_fin.to(f32)
    for t in range(n - 1, -1, -1):
        g = carry + dhs[t].to(f32)
        h_prev = h0.to(f32) if t == 0 else hbuf[t].to(f32)
        r, z, nn, hn = _gates(xg[t], hg[t], h_prev, hdim)
        dn = g * (1.0 - z)
        dz = g * (h_prev - nn)
        dtanh = dn * (1.0 - nn * nn)
        dhn = dtanh * r
        dr = dtanh * hn
        dxr = dr * r * (1.0 - r)
        dxz = dz * z * (1.0 - z)
        dx_t = torch.cat([dxr, dxz, dtanh], dim=1)
        dh_t = torch.cat([dxr, dxz, dhn], dim=1)
        dbih += dx_t.sum(0)
        dbhh += dh_t.sum(0)
        d_xg[t] = dx_t.to(wt)
        d_hg[t] = dh_t.to(wt)
        carry = g * z + torch.matmul(d_hg[t].to(f32), w_hh.T)
    rows = n * b
    dxg2 = d_xg.to(f32).reshape(rows, 3 * hdim)
    dhg2 = d_hg.to(f32).reshape(rows, 3 * hdim)
    dx = torch.matmul(dxg2, wih.to(wt).to(f32).T).to(wt).reshape(n, b, hdim)
    dwih = torch.matmul(x.to(wt).to(f32).reshape(rows, hdim).T, dxg2)
    dwhh = torch.matmul(hbuf[:n].to(f32).reshape(rows, hdim).T, dhg2)
    return dx, carry, dwih, dbih, dwhh, dbhh


def gru_sequence_bwd(x, h0, wih, whh, hbuf, xg, hg, dh_seq, dh_fin,
                     weights_dtype="bfloat16", plan=None):
    """K4 backward: the kernel on CUDA tensors, its plain version on CPU
    tensors; arguments and results as ``gru_sequence_bwd_plain``;
    ``plan`` as ``gru_sequence_fwd``'s."""
    if _on_cpu(x, h0, wih, whh, hbuf, xg, hg, dh_seq, dh_fin):
        return gru_sequence_bwd_plain(x, h0, wih, whh, hbuf, xg, hg, dh_seq,
                                      dh_fin, weights_dtype)
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    xq = x.to(wt).contiguous()
    w_ih, w_hh = wih.to(wt).contiguous(), whh.to(wt).contiguous()
    h0f = h0.to(f32).contiguous()
    dhs = dh_seq.to(wt).contiguous()
    dhf = dh_fin.to(f32).contiguous()
    _check(w_ih, "wih", (wt,), (hdim, 3 * hdim))
    _check(w_hh, "whh", (wt,), (hdim, 3 * hdim))
    _check(hbuf, "hbuf", (wt,), (n + 1, b, hdim))
    _check(xg, "xg", (f32,), (n, b, 3 * hdim))
    _check(hg, "hg", (f32,), (n, b, 3 * hdim))
    _check(dhs, "dh_seq", (wt,), (n, b, hdim))
    _check(dhf, "dh_fin", (f32,), (b, hdim))
    dev = x.device
    d_xg = torch.empty((n, b, 3 * hdim), dtype=wt, device=dev)
    d_hg = torch.empty_like(d_xg)
    dx = torch.empty((n, b, hdim), dtype=wt, device=dev)
    dh0 = torch.empty((b, hdim), dtype=f32, device=dev)
    dwih = torch.empty((hdim, 3 * hdim), dtype=f32, device=dev)
    dwhh = torch.empty_like(dwih)
    dbih = torch.empty(3 * hdim, dtype=f32, device=dev)
    dbhh = torch.empty_like(dbih)
    pa, flags, bpart = _scratch("gru", hdim, b, wt, dev, plan, bwd=True)
    _launch("gru_sequence_bwd", xq.data_ptr(), h0f.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), hbuf.data_ptr(),
            xg.data_ptr(), hg.data_ptr(), dhs.data_ptr(), dhf.data_ptr(),
            d_xg.data_ptr(), d_hg.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
            dwih.data_ptr(), dbih.data_ptr(), dwhh.data_ptr(),
            dbhh.data_ptr(), _ptr(bpart), _ptr(flags), n, b, hdim,
            int(wt == torch.bfloat16), ctypes.addressof(pa), _stream(x))
    return dx, dh0, dwih, dbih, dwhh, dbhh


# ------------------------------------------------------ the function --

class _GruSequence(torch.autograd.Function):
    """Forward launches the forward kernel; backward the backward kernel
    (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, h0, wih, bih, whh, bhh, weights_dtype):
        wt = _weights_dtype(weights_dtype)
        xq = x.to(wt)
        hbuf, h_fin, xg, hg = gru_sequence_fwd(xq, h0, wih, bih, whh, bhh,
                                               wt)
        ctx.save_for_backward(xq, h0, wih, whh, hbuf, xg, hg)
        ctx.meta = (wt, x.dtype, bih.shape, bhh.shape)
        return hbuf[1:].to(torch.float32, copy=True), h_fin

    @staticmethod
    def backward(ctx, dh_seq, dh_fin):
        xq, h0, wih, whh, hbuf, xg, hg = ctx.saved_tensors
        wt, x_dtype, bih_shape, bhh_shape = ctx.meta
        if dh_seq is None:
            dh_seq = torch.zeros(xq.shape, dtype=wt, device=xq.device)
        if dh_fin is None:
            dh_fin = torch.zeros_like(h0, dtype=torch.float32)
        dx, dh0, dwih, dbih, dwhh, dbhh = gru_sequence_bwd(
            xq, h0, wih, whh, hbuf, xg, hg, dh_seq, dh_fin, wt)
        return (dx.to(x_dtype), dh0, dwih.to(wih.dtype),
                dbih.reshape(bih_shape), dwhh.to(whh.dtype),
                dbhh.reshape(bhh_shape), None)


def gru_sequence(x_seq, h0, wih, bih, whh, bhh, weights_dtype="bfloat16"):
    """Run a GRU over x_seq [N, B, H_in == H]; returns (h_seq [N, B, H]
    float32, h_final [B, H] float32), differentiable through the backward
    kernel."""
    return _GruSequence.apply(x_seq, h0, wih, bih, whh, bhh, weights_dtype)


# ------------------------------------------------------ LSTM: K5 --

def _lstm_gates(g, hdim):
    return (torch.sigmoid(g[:, :hdim]), torch.sigmoid(g[:, hdim:2 * hdim]),
            torch.tanh(g[:, 2 * hdim:3 * hdim]),
            torch.sigmoid(g[:, 3 * hdim:]))


def lstm_sequence_fwd_plain(x, h0, c0, wih, bih, whh, bhh,
                            weights_dtype="bfloat16"):
    """Plain version of K5's forward kernel.  x [N, B, H]; h0, c0 [B, H];
    wih/whh [H, 4H]; biases [4H].  Returns (hbuf [N+1, B, H] in the
    weights dtype with hbuf[0] = round(h0) and hbuf[t+1] = round(h_t),
    c_seq [N, B, H] in the weights dtype, h_fin and c_fin [B, H] float32,
    g [N, B, 4H] float32, the gate pre-activations xg + hg)."""
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    w_hh = whh.to(wt).to(f32)
    g = (torch.matmul(x.to(wt).to(f32).reshape(n * b, hdim),
                      wih.to(wt).to(f32))
         + bih.to(f32).reshape(-1)).reshape(n, b, 4 * hdim)
    hbuf = torch.empty((n + 1, b, hdim), dtype=wt, device=x.device)
    hbuf[0] = h0.to(wt)
    c_seq = torch.empty((n, b, hdim), dtype=wt, device=x.device)
    h, c = h0.to(f32), c0.to(f32)
    for t in range(n):
        hg = torch.matmul(hbuf[t].to(f32), w_hh) + bhh.to(f32).reshape(-1)
        g[t] = g[t] + hg
        i, f, gg, o = _lstm_gates(g[t], hdim)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        hbuf[t + 1] = h.to(wt)
        c_seq[t] = c.to(wt)
    return hbuf, c_seq, h, c, g


def lstm_sequence_fwd(x, h0, c0, wih, bih, whh, bhh,
                      weights_dtype="bfloat16", plan=None):
    """K5 forward: the kernel on CUDA tensors, its plain version on CPU
    tensors; arguments and results as ``lstm_sequence_fwd_plain``;
    ``plan`` as ``gru_sequence_fwd``'s."""
    if _on_cpu(x, h0, c0, wih, bih, whh, bhh):
        return lstm_sequence_fwd_plain(x, h0, c0, wih, bih, whh, bhh,
                                       weights_dtype)
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    xq = x.to(wt).contiguous()
    w_ih, w_hh = wih.to(wt).contiguous(), whh.to(wt).contiguous()
    b_ih = bih.to(f32).reshape(-1).contiguous()
    b_hh = bhh.to(f32).reshape(-1).contiguous()
    h0f, c0f = h0.to(f32).contiguous(), c0.to(f32).contiguous()
    for t, name in ((w_ih, "wih"), (w_hh, "whh")):
        _check(t, name, (wt,), (hdim, 4 * hdim))
    for t, name in ((b_ih, "bih"), (b_hh, "bhh")):
        _check(t, name, (f32,), (4 * hdim,))
    for t, name in ((h0f, "h0"), (c0f, "c0")):
        _check(t, name, (f32,), (b, hdim))
    dev = x.device
    g = torch.empty((n, b, 4 * hdim), dtype=f32, device=dev)
    hbuf = torch.empty((n + 1, b, hdim), dtype=wt, device=dev)
    c_seq = torch.empty((n, b, hdim), dtype=wt, device=dev)
    hfin = torch.empty((b, hdim), dtype=f32, device=dev)
    cfin = torch.empty_like(hfin)
    pa, flags, _ = _scratch("lstm", hdim, b, wt, dev, plan)
    _launch("lstm_sequence_fwd", xq.data_ptr(), h0f.data_ptr(),
            c0f.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
            w_hh.data_ptr(), b_hh.data_ptr(), g.data_ptr(), hbuf.data_ptr(),
            c_seq.data_ptr(), hfin.data_ptr(), cfin.data_ptr(), _ptr(flags),
            n, b, hdim, int(wt == torch.bfloat16), ctypes.addressof(pa),
            _stream(x))
    return hbuf, c_seq, hfin, cfin, g


def lstm_sequence_bwd_plain(x, c0, wih, whh, hbuf, c_seq, g, dh_seq, dh_fin,
                            dc_fin, weights_dtype="bfloat16"):
    """Plain version of K5's backward kernel.  x, c0, wih, whh as the
    forward; hbuf, c_seq, g its residuals; dh_seq [N, B, H]; dh_fin,
    dc_fin [B, H].  Returns (dx [N, B, H] in the weights dtype, dh0, dc0
    [B, H], dwih [H, 4H], dbih [4H], dwhh [H, 4H], dbhh [4H], all float32
    but dx)."""
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    w_hh = whh.to(wt).to(f32)
    dhs = dh_seq.to(wt)
    dg = torch.empty((n, b, 4 * hdim), dtype=wt, device=x.device)
    db = torch.zeros(4 * hdim, dtype=f32, device=x.device)
    dh, dc = dh_fin.to(f32), dc_fin.to(f32)
    for t in range(n - 1, -1, -1):
        gh = dh + dhs[t].to(f32)
        c_prev = c0.to(f32) if t == 0 else c_seq[t - 1].to(f32)
        i, f, gg, o = _lstm_gates(g[t], hdim)
        tc = torch.tanh(c_seq[t].to(f32))
        d_o = gh * tc
        dct = gh * o * (1.0 - tc * tc) + dc
        di, df, dgg = dct * gg, dct * c_prev, dct * i
        d = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                       dgg * (1.0 - gg * gg), d_o * o * (1.0 - o)], dim=1)
        db += d.sum(0)
        dg[t] = d.to(wt)
        dh = torch.matmul(dg[t].to(f32), w_hh.T)
        dc = dct * f
    rows = n * b
    dg2 = dg.to(f32).reshape(rows, 4 * hdim)
    dx = torch.matmul(dg2, wih.to(wt).to(f32).T).to(wt).reshape(n, b, hdim)
    dwih = torch.matmul(x.to(wt).to(f32).reshape(rows, hdim).T, dg2)
    dwhh = torch.matmul(hbuf[:n].to(f32).reshape(rows, hdim).T, dg2)
    return dx, dh, dc, dwih, db, dwhh, db.clone()


def lstm_sequence_bwd(x, c0, wih, whh, hbuf, c_seq, g, dh_seq, dh_fin,
                      dc_fin, weights_dtype="bfloat16", plan=None):
    """K5 backward: the kernel on CUDA tensors, its plain version on CPU
    tensors; arguments and results as ``lstm_sequence_bwd_plain``;
    ``plan`` as ``gru_sequence_fwd``'s."""
    if _on_cpu(x, c0, wih, whh, hbuf, c_seq, g, dh_seq, dh_fin, dc_fin):
        return lstm_sequence_bwd_plain(x, c0, wih, whh, hbuf, c_seq, g,
                                       dh_seq, dh_fin, dc_fin, weights_dtype)
    wt = _weights_dtype(weights_dtype)
    f32 = torch.float32
    n, b, hdim = x.shape
    xq = x.to(wt).contiguous()
    w_ih, w_hh = wih.to(wt).contiguous(), whh.to(wt).contiguous()
    c0f = c0.to(f32).contiguous()
    dhs = dh_seq.to(wt).contiguous()
    dhf, dcf = dh_fin.to(f32).contiguous(), dc_fin.to(f32).contiguous()
    for t, name in ((w_ih, "wih"), (w_hh, "whh")):
        _check(t, name, (wt,), (hdim, 4 * hdim))
    _check(hbuf, "hbuf", (wt,), (n + 1, b, hdim))
    _check(c_seq, "c_seq", (wt,), (n, b, hdim))
    _check(g, "g", (f32,), (n, b, 4 * hdim))
    _check(dhs, "dh_seq", (wt,), (n, b, hdim))
    for t, name in ((c0f, "c0"), (dhf, "dh_fin"), (dcf, "dc_fin")):
        _check(t, name, (f32,), (b, hdim))
    dev = x.device
    dg = torch.empty((n, b, 4 * hdim), dtype=wt, device=dev)
    dx = torch.empty((n, b, hdim), dtype=wt, device=dev)
    dh0 = torch.empty((b, hdim), dtype=f32, device=dev)
    dc0 = torch.empty_like(dh0)
    dwih = torch.empty((hdim, 4 * hdim), dtype=f32, device=dev)
    dwhh = torch.empty_like(dwih)
    dbih = torch.empty(4 * hdim, dtype=f32, device=dev)
    dbhh = torch.empty_like(dbih)
    pa, flags, bpart = _scratch("lstm", hdim, b, wt, dev, plan, bwd=True)
    _launch("lstm_sequence_bwd", xq.data_ptr(), c0f.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), hbuf.data_ptr(),
            c_seq.data_ptr(), g.data_ptr(), dhs.data_ptr(), dhf.data_ptr(),
            dcf.data_ptr(), dg.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), dwih.data_ptr(), dbih.data_ptr(),
            dwhh.data_ptr(), dbhh.data_ptr(), _ptr(bpart), _ptr(flags), n, b,
            hdim, int(wt == torch.bfloat16), ctypes.addressof(pa),
            _stream(x))
    return dx, dh0, dc0, dwih, dbih, dwhh, dbhh


class _LstmSequence(torch.autograd.Function):
    """Forward launches K5's forward kernel; backward its backward kernel
    (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, hc0, wih, bih, whh, bhh, weights_dtype):
        wt = _weights_dtype(weights_dtype)
        xq = x.to(wt)
        h0, c0 = hc0[0], hc0[1]
        hbuf, c_seq, h_fin, c_fin, g = lstm_sequence_fwd(
            xq, h0, c0, wih, bih, whh, bhh, wt)
        ctx.save_for_backward(xq, c0, wih, whh, hbuf, c_seq, g)
        ctx.meta = (wt, x.dtype, bih.shape, bhh.shape)
        return (hbuf[1:].to(torch.float32, copy=True),
                torch.stack([h_fin, c_fin]))

    @staticmethod
    def backward(ctx, dh_seq, dhc_fin):
        xq, c0, wih, whh, hbuf, c_seq, g = ctx.saved_tensors
        wt, x_dtype, bih_shape, bhh_shape = ctx.meta
        if dh_seq is None:
            dh_seq = torch.zeros(xq.shape, dtype=wt, device=xq.device)
        if dhc_fin is None:
            dhc_fin = torch.zeros((2,) + tuple(c0.shape),
                                  dtype=torch.float32, device=c0.device)
        dx, dh0, dc0, dwih, dbih, dwhh, dbhh = lstm_sequence_bwd(
            xq, c0, wih, whh, hbuf, c_seq, g, dh_seq, dhc_fin[0],
            dhc_fin[1], wt)
        return (dx.to(x_dtype), torch.stack([dh0, dc0]), dwih.to(wih.dtype),
                dbih.reshape(bih_shape), dwhh.to(whh.dtype),
                dbhh.reshape(bhh_shape), None)


def lstm_sequence(x_seq, hc0, wih, bih, whh, bhh, weights_dtype="bfloat16"):
    """Run an LSTM over x_seq [N, B, H_in == H] from hc0 [2, B, H] (h, c);
    returns (h_seq [N, B, H] float32, hc_final [2, B, H] float32),
    differentiable through K5's backward kernel."""
    return _LstmSequence.apply(x_seq, hc0, wih, bih, whh, bhh, weights_dtype)

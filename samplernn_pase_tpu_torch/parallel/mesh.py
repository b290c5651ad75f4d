"""Device mesh and sharding rules, as ``samplernn_pase_tpu.parallel.mesh``.

In the reference a ``Mesh`` is placement: one process drives every device
and XLA inserts the gradient ``psum``, the global means and the gathers.
Here the idiom is one process per rank under ``torch.distributed``: a
``DeviceMesh`` names the ranks' axes, every tensor a rank holds is a plain
local tensor (the kernels take raw tensors, so there is no DTensor), and
every collective the reference leaves to XLA is written out:

- ``data`` shards the batch, the TBPTT hiddens (axis -2 of a tier state)
  and the serving pool's lanes.  A rank holds a contiguous block, the rows
  ``P("data")`` gives.  Parameters and optimizer state are replicated;
  gradients are summed over ``data`` (``all_reduce_grads``) and the loss
  is divided by the global count of targets.
- ``model`` (size 1 unless asked for) column-shards the sample MLP's
  ``w_in`` and ``w_h`` and row-shards its ``w_out`` (``shard_params``),
  as ``mesh.py:54-69`` of the reference does; ``models.sample_mlp``
  runs the sharded products with the autograd collectives below.

The collectives used are ``all_reduce``, ``all_gather`` and ``broadcast``
only: gloo takes CUDA tensors for those three (staging through the host),
so two ranks can share one card over gloo, which NCCL refuses.  16-bit
tensors travel as float32.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

AXES = ("data", "model")


# ------------------------------------------------------------ the mesh

def make_mesh(shape=None, axis_names=("data",), device_type=None):
    """A ``DeviceMesh`` over the initialized default process group: by
    default the whole world on one ``data`` axis (a size-1 ``model`` axis
    when two names are given).  ``device_type`` only names the placement
    DTensor would use; it defaults to ``"cuda"`` under NCCL and
    ``"cpu"`` otherwise (two ranks sharing a card over gloo hold CUDA
    tensors all the same: the collectives here take their group from the
    mesh, not its device type)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    axis_names = tuple(axis_names)
    unknown = set(axis_names) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the "
                         f"axes are {AXES}")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not hold the world of {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axis_names)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 without a mesh or without that axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where it has none)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group along ``axis`` (a one-rank group too: a mesh of
    one rank still runs its collectives), or None without a mesh or
    without that axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def model_group(mesh):
    """The ``model`` group where the axis splits the MLP (size > 1),
    else None: a size-1 ``model`` axis leaves the MLP whole."""
    return axis_group(mesh, "model") if axis_size(mesh, "model") > 1 else None


def data_mesh(mesh):
    """The mesh's ``data`` axis alone (the view ``Trainer`` trains on: it
    replicates parameters, as the reference's does); None stays None."""
    if mesh is None or mesh.ndim == 1:
        return mesh
    return mesh["data"]


def is_chief(mesh=None) -> bool:
    """True on the one rank that writes files: global rank 0, or any
    process without a mesh."""
    return mesh is None or dist.get_rank() == 0


def rank_device(device=None) -> torch.device:
    """This rank's device.  Under NCCL, ``cuda:{LOCAL_RANK}`` (set as the
    current device); a rank without a card of its own raises, naming the
    count.  Under gloo, ``device`` as given (two ranks share one card only
    this way), else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(
                f"NCCL rank {dist.get_rank()} (local rank {local}) of "
                f"{dist.get_world_size()} needs a card of its own and this "
                f"host shows {n}; run at most {n} ranks per host, or share "
                "a card by initializing the group with gloo and passing the "
                "device")
        torch.cuda.set_device(local)
        return torch.device("cuda", local)
    return torch.device("cpu" if device is None else device)


# ----------------------------------------------------- raw collectives

def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in (torch.float16, torch.bfloat16) else t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` as a new tensor (16-bit tensors are
    summed in float32); ``t`` itself when the group is None."""
    if group is None:
        return t
    w = _wide(t).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(w, group=group)
    return w.to(t.dtype)


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    if group is None:
        return t
    w = _wide(t).contiguous()
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


# ------------------------------------------------ autograd collectives

class _EnterModel(torch.autograd.Function):
    """Identity forward, sum over the ``model`` group backward: a
    replicated input entering the sharded MLP, so that every replicated
    parameter upstream gets the whole of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumModel(torch.autograd.Function):
    """Sum over the ``model`` group forward, identity backward: the row
    shards' partial logits, whose sum every rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gather along the last axis forward; backward, the sum of every
    rank's gradient, sliced to this rank's columns (a reduce-scatter made
    of ``all_reduce``, which gloo takes on CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.rank = dist.get_rank(group)
        return all_gather_cat(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return all_reduce(g, ctx.group)[..., lo:lo + ctx.width], None


def enter_model(x, group):
    return x if group is None else _EnterModel.apply(x, group)


def sum_model(x, group):
    return x if group is None else _SumModel.apply(x, group)


def gather_model(x, group):
    return x if group is None else _GatherModel.apply(x, group)


class _SumBoth(torch.autograd.Function):
    """Sum over the group forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def sum_differentiable(x, group):
    """The sum over ``group`` with the sum of the ranks' gradients flowing
    back: a statistic every rank's loss depends on (BatchNorm's, a
    row-sharded weight's norm).  The semantics of
    ``torch.distributed.nn.functional.all_reduce``, kept here so that the
    four autograd collectives share one ``all_reduce`` (16-bit inputs
    summed in float32)."""
    return x if group is None else _SumBoth.apply(x, group)


# ------------------------------------------------------- placement

@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on the mesh: ``dim`` split in contiguous
    blocks over ``axis`` (None: replicated).  ``shard`` takes a rank's
    block of a whole host array or tensor; ``gather`` puts the blocks
    back together on every rank."""

    mesh: object
    dim: int | None
    axis: str = "data"

    def shard(self, x):
        n = axis_size(self.mesh, self.axis)
        if self.dim is None or n == 1:
            return x
        size = x.shape[self.dim]
        if size % n:
            raise ValueError(f"axis {self.dim} of size {size} does not "
                             f"divide over the mesh's {self.axis} axis "
                             f"({n})")
        blk = size // n
        lo = axis_rank(self.mesh, self.axis) * blk
        idx = [slice(None)] * x.ndim
        idx[self.dim] = slice(lo, lo + blk)
        return x[tuple(idx)]

    def gather(self, x):
        if self.dim is None:
            return x
        return all_gather_cat(x, axis_group(self.mesh, self.axis),
                              self.dim)


def batch_sharding(mesh, ndim: int = 2) -> Sharding:
    """Shard axis 0 (batch) over ``data``; replicate the rest."""
    return Sharding(mesh, 0)


def staged_sharding(mesh, ndim: int) -> Sharding:
    """[K, B, ...] staged multi-step batches: batch is axis 1."""
    return Sharding(mesh, 1)


def state_sharding(mesh, state_leaf_ndim: int) -> Sharding:
    """Per-tier RNN state [n_rnn, (2,)? B, H]: batch is axis -2."""
    return Sharding(mesh, state_leaf_ndim - 2)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh, tree):
    """A rank's block of axis 0 of every leaf of a host batch tree (a
    0-d leaf is kept whole)."""
    def one(x):
        if x is None or np.ndim(x) == 0:
            return x
        return batch_sharding(mesh, np.ndim(x)).shard(x)
    return tree_map(one, tree)


def shard_state(mesh, states):
    """A rank's lanes of a tuple of tier states (axis -2)."""
    return tuple(state_sharding(mesh, s.dim()).shard(s) for s in states)


def gather_state(mesh, states):
    """The whole batch of a tuple of tier states on every rank."""
    return tuple(state_sharding(mesh, s.dim()).gather(s) for s in states)


def gather_batch(mesh, x, dim: int = 0):
    """The whole batch of a rank-local tensor on every rank."""
    return Sharding(mesh, dim).gather(x)


# ------------------------------------------ the sample MLP's shards

_COLUMN = ("w_in", "w_h")


def _shard_dim(path) -> int | None:
    """The axis a parameter's leaf is split along on the ``model`` axis,
    from its path in a tree (a parameter tree, or the ``mu``/``nu`` of
    an optimizer state): ``mlp.w_in`` and ``mlp.w_h`` by columns, their
    weight-norm gains with them; ``mlp.w_out`` by rows (its gain, one per
    output, is replicated)."""
    if "mlp" not in path:
        return None
    name = path[path.index("mlp") + 1] if path.index("mlp") + 1 < len(
        path) else None
    tail = path[-1]
    if name in _COLUMN and tail in (name, "v", "g"):
        return -1
    if name == "w_out" and tail in ("w_out", "v"):
        return 0
    return None


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(params, mesh):
    """This rank's parameters: replicated unless the mesh has a ``model``
    axis > 1, where the sample MLP's matrices are split (``_shard_dim``).
    Takes any tree whose paths hold the parameters' (an optimizer state
    too)."""
    if axis_size(mesh, "model") == 1:
        return params

    def rule(path, leaf):
        d = _shard_dim(path)
        if d is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return Sharding(mesh, d % leaf.dim(), "model").shard(leaf)
    return _map_path(rule, params)


def unshard_params(params, mesh):
    """``shard_params``' inverse: the whole matrices on every rank."""
    if axis_size(mesh, "model") == 1:
        return params

    def rule(path, leaf):
        d = _shard_dim(path)
        if d is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return Sharding(mesh, d % leaf.dim(), "model").gather(leaf)
    return _map_path(rule, params)


def mlp_is_sharded(mlp) -> bool:
    """Whether an MLP tree holds column shards (``w_h`` narrower than
    the hidden width its biases give)."""
    w = mlp["w_h"]
    w = w["v"] if isinstance(w, dict) else w
    return w.shape[-1] != mlp["b_h"].shape[0]


# ------------------------------------------------- the step's reductions

def _flat_sum(tensors, group):
    """``tensors`` summed over ``group`` in one flat float32 buffer."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([_wide(t).reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].view_as(t).to(t.dtype))
        lo += t.numel()
    return out


def all_reduce_grads(grads, mesh):
    """Gradients summed over ``data`` (the reference's XLA-inserted
    ``psum``), in one collective."""
    group = axis_group(mesh, "data")
    if group is None:
        return grads
    return tree_unflatten(grads, _flat_sum(tree_leaves(grads), group))


def grad_sq_norm(grads, mesh):
    """The squared global norm of a gradient tree under the mesh: a
    sharded leaf's squares summed over ``model``, a replicated leaf's
    counted once (the gradients are already summed over ``data``)."""
    sharded, whole = [], []

    def visit(path, g):
        (sharded if _shard_dim(path) is not None
         and axis_size(mesh, "model") > 1 else whole).append(
            torch.sum(g * g))
        return g
    _map_path(visit, grads)
    total = sum(whole)
    if sharded:
        total = total + all_reduce(sum(sharded), axis_group(mesh, "model"))
    return total

"""Debug-mode numerics checks, as ``samplernn_pase_tpu.utils.debug``.

The reference wraps a function in ``checkify.float_checks``: the output
of every primitive is checked for NaN, and every division for a zero
divisor.  Here a ``TorchDispatchMode`` sees every aten op the function
runs and checks its floating outputs.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ops whose outputs are uninitialised memory, not results
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided", "resize_",
                            "set_"})


def _finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return (not x.is_floating_point() or x.numel() == 0
                or bool(torch.isfinite(x).all()))
    if isinstance(x, float):
        return math.isfinite(x)
    return True


class _FloatChecks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        if not all(_finite(o) for o in tree_leaves(out)) and all(
                _finite(a) for a in tree_leaves((args, kwargs))):
            raise ValueError(f"checked: {func} produced a NaN or an inf "
                             "from finite inputs")
        return out


def checked(fn):
    """Wrap ``fn`` so that it raises ``ValueError`` at the first aten op
    that turns finite inputs into a NaN or an inf, naming the op, and when
    a floating output of ``fn`` is not finite.  Results and gradients are
    otherwise those of ``fn``.

    Usage:
        step_dbg = checked(train_step)
        out = step_dbg(*args)   # raises ValueError on NaN/Inf

    Like the reference, an intermediate NaN raises even when a later
    ``torch.where`` masks it out of the result.  Unlike it, an inf from
    finite inputs raises too (the reference flags only a zero divisor);
    a division by zero gives one, so both raise there.  Every check reads
    the op's output on the host: one device sync per op on the card.  The
    port's CUDA kernels are launched through ``ctypes``, so the dispatcher
    never sees them: what they write is checked where an aten op reads it
    and in ``fn``'s outputs."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks():
            out = fn(*args, **kwargs)
        if not all(_finite(o) for o in tree_leaves(out)):
            raise ValueError(f"checked: {getattr(fn, '__name__', fn)} "
                             "returned a NaN or an inf")
        return out

    return wrapper

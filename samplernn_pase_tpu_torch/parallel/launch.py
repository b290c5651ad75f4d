"""Spawning ranks: ``run_ranks`` runs a function in N processes, each in a
gloo process group, and returns what each rank returned.

The reference proves its mesh paths on N virtual CPU devices inside one
process; here a rank is a process, so the tests, ``graft_entry.
dryrun_multichip`` and the smoke's mesh phase spawn them.  Every run has a
deadline: a rank that raises ends the run at once (the others are
terminated, since they may wait in a collective for it), and ranks still
running at the deadline are terminated, so a hang fails instead of
waiting.
"""

from __future__ import annotations

import datetime
import multiprocessing
import shutil
import tempfile
import time
import traceback
from pathlib import Path


def _rank_main(fn, rank, world, init, device, out, args):
    import torch
    import torch.distributed as dist

    if device is None:
        torch.set_num_threads(1)        # N CPU ranks share the host's cores
    elif torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=600))
        try:
            result = fn(rank, world, *args)
            torch.save(result, out / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world: int, args=(), *, timeout: float = 600.0,
              device=None):
    """``fn(rank, world, *args)`` in ``world`` spawned processes under
    gloo (a ``file://`` store in a fresh temporary directory); ``device``,
    when it is a CUDA device, is every rank's current device (ranks share
    one card this way), and without one each rank keeps one intra-op
    thread.  ``fn`` must be importable by name (a module-level
    function).  Returns the ranks' return values in rank order, or raises
    RuntimeError with the failing rank's traceback, or on the deadline."""
    ctx = multiprocessing.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="srnn_ranks_"))
    init = f"file://{tmp / 'store'}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init,
                               None if device is None else str(device),
                               tmp, tuple(args)), daemon=False)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"ranks {[r for r, p in enumerate(procs) if p.is_alive()]}"
                    f" of {world} still running after {timeout:.0f} s")
            time.sleep(0.05)
        errs = [f"rank {r} (exit {p.exitcode}):\n"
                + ((tmp / f"rank{r}.err").read_text()
                   if (tmp / f"rank{r}.err").exists() else "")
                for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if errs:
            raise RuntimeError("\n".join(errs))
        import torch
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        procs = [p for p in procs if p.pid is not None]     # started
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)

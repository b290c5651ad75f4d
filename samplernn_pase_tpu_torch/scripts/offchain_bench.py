"""K1 beside the GRU tiers' next recurrent products, and the whole
generation's device time per top frame, on the card.

    python -m samplernn_pase_tpu_torch.scripts.offchain_bench [--root DIR]

``megagen._frames`` launches each GRU tier's next ``hg = h @ w_hh + b_hh``
right after K1, as a programmatic dependent, so that it runs on the SMs
K1 leaves idle (``megagen``'s module docstring).  At the stacked
flagship's shape (samplernn-pytorch's default: 2 tiers (16, 4), two GRU
layers of 1,024, bf16, B=128, T=1) this times, in turns:

* ``k1``: K1 alone, one bottom frame a step;
* ``k1_beside_4`` and ``k1_beside_2``: K1, then the products a first
  and a later bottom frame put beside it (4: both tiers' two layers; 2:
  the bottom tier's), through ``megagen.beside_k1`` with its join;
* ``hg_4``: the 4 products alone, in series, as on the chain.

Each step is replayed from a CUDA graph of ``REPS`` steps (and, as
``eager_*``, launched one by one): ``us`` is the wall per step (CUDA
events over the replays), ``k1_us`` and ``hg_us`` K1's and K2's device
time per step (torch.profiler over the replays), so ``k1_us`` beside
against alone is what the products cost K1 (beside K1, ``hg_us`` runs
to K1's end: a programmatic dependent completes with the kernel before
it).  Then ``gen``: ``megagen.run``
over ``N_TOP`` top frames (graphed) for the stacked flagship and config
4 (unconditioned), ms per top frame from CUDA events around the call
(the card paces the call: this is its device time), median of
``CALLS``.  ``--root DIR`` times ``DIR``'s ``megagen.run`` (a checkout,
e.g. a ``git archive`` of the parent under ``build/``) in a subprocess
on the same inputs, in the order root, this tree, this tree, root.  The
last line is one JSON object.  It needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

B = 128
REPS = 40
N_TOP = 20 * 16            # 20 graph blocks
CALLS = 3
MODELS = ("srnnpt_default", "c4")


def model(torch, name: str):
    """(config, prepared bf16 weights) of the stacked flagship
    (``configs/c5_gen_b128.json`` with n_rnn 2 and weight norm) or config
    4, from seed 0."""
    import dataclasses
    from pathlib import Path

    from samplernn_pase_tpu_torch.config import load_config
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.kernels import megagen
    root = Path(megagen.__file__).resolve().parents[3] / "configs"
    if name == "c4":
        cfg = load_config(root / "c4_tts_conditioned.json").model
    else:
        flagship = load_config(root / "c5_gen_b128.json").model
        cfg = dataclasses.replace(flagship, n_rnn=2, weight_norm=True)
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   torch.device("cuda"))
    return cfg, megagen.prepare(params["tiers"], params["mlp"],
                                torch.bfloat16)


def gen_ms(torch, name: str) -> float:
    """``megagen.run``'s ms per top frame, graphed, median of ``CALLS``."""
    from samplernn_pase_tpu_torch.ops.kernels import megagen
    cfg, weights = model(torch, name)
    gen = torch.Generator().manual_seed(1)
    window = torch.randint(0, cfg.q_levels, (B, cfg.lookback), generator=gen,
                           dtype=torch.int32).cuda()
    states = tuple((0.5 * torch.randn(cfg.n_rnn, B, cfg.dim,
                                      generator=gen)).cuda()
                   for _ in cfg.frame_sizes)
    megagen.run(weights, window, states, 1.0, N_TOP, cfg.q_levels, seed=3)
    times = []
    for call in range(CALLS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        megagen.run(weights, window, states, 1.0, N_TOP, cfg.q_levels,
                    seed=4 + call)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / N_TOP)
    return statistics.median(times)


def beside(torch, kdec, weights) -> dict:
    """The four step forms (module docstring) on one bottom frame's inputs
    -> {form: zero-argument function launching one step}; the products
    beside K1 go through ``megagen.beside_k1``, as in generation."""
    from samplernn_pase_tpu_torch.ops.kernels import megagen
    tiers, mw = weights["tiers"], weights["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    hdim = tiers[0]["b_in"].shape[0]
    window = torch.randint(0, 256, (B, tiers[0]["b_up"].shape[0]),
                           device="cuda", generator=gen, dtype=torch.int32)
    rows = kdec.gemm_bias(torch.randn(B, hdim, device="cuda", generator=gen),
                          tiers[0]["w_up"])
    out = torch.empty_like(window)
    products = [(torch.randn(B, hdim, device="cuda", generator=gen) * 0.5,
                 lw, torch.empty((B, lw["w_hh"].shape[1]), device="cuda"))
                for k in (1, 0) for lw in tiers[k]["layers"]]
    joins = []

    def k1():
        kdec.frame_decode(window, rows, tiers[0]["b_up"], mw, 1.0, None, 7, 0,
                          out)

    def hg(n):
        for h, lw, o in products[-n:]:
            kdec.gemm_bias(h, lw["w_hh"], lw["b_hh"], out=o)

    def k1_beside(n):
        k1()
        megagen.beside_k1(kdec.KERNELS, products[-n:], joins)

    return {"k1": k1, "k1_beside_4": lambda: k1_beside(4),
            "k1_beside_2": lambda: k1_beside(2),
            "hg_4": lambda: hg(4)}


def kernel_us(torch, fn, reps: int) -> dict:
    """Device us per step of K1 (``frame_decode``) and of K2
    (``skinny_gemm``) over ``reps`` steps of ``fn`` (torch.profiler);
    raises where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = {"k1_us": 0.0, "hg_us": 0.0}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if "frame_decode" in e.key:
                got["k1_us"] += us / reps
            elif "skinny_gemm" in e.key:
                got["hg_us"] += us / reps
        if got["k1_us"] + got["hg_us"] > 0:
            return got
    raise RuntimeError("torch.profiler gave no device time")


def time_forms(torch, kdec, forms) -> dict:
    """Each form as a CUDA graph of ``REPS`` steps and launched eagerly:
    wall us per step (events) and kernel us per step (profiler)."""
    graphs = {}
    for name, step in forms.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(REPS):
                step()
        graphs[name] = g

    def eager(step):
        def run():
            for _ in range(REPS):
                step()
        return run

    result = {}
    for turn in range(2):
        for name, step in forms.items():
            for label, run in ((name, graphs[name].replay),
                               ("eager_" + name, eager(step))):
                run()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                torch.cuda.synchronize()
                e0.record()
                run()
                e1.record()
                torch.cuda.synchronize()
                row = {"us": 1000.0 * e0.elapsed_time(e1) / REPS}
                row.update(kernel_us(torch, run, REPS))
                result.setdefault(label, []).append(row)
                print(f"turn {turn} {label}: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in row.items()), flush=True)
    return result


def root_gen(root: str) -> dict:
    """``root``'s ms per top frame, from a subprocess that imports the
    port from there."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--gen-only",
         "--port", root], capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose megagen.run to time beside this "
                         "tree's")
    ap.add_argument("--gen-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    import torch
    if not torch.cuda.is_available():
        print("offchain_bench: no CUDA device", file=sys.stderr)
        return 1
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec
    if args.gen_only:
        print(json.dumps({name: gen_ms(torch, name) for name in MODELS}))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "lanes": B, "reps": REPS}
    _, weights = model(torch, "srnnpt_default")
    result["forms"] = time_forms(torch, kdec, beside(torch, kdec, weights))
    del weights
    gen = result["gen_ms_per_top_frame"] = {"this": []}
    if args.root:
        gen["root"] = [root_gen(args.root)]
        print(f"root {args.root}: ms per top frame {gen['root'][0]}",
              flush=True)
    for _ in range(2):
        gen["this"].append({name: gen_ms(torch, name) for name in MODELS})
        print(f"this tree: ms per top frame {gen['this'][-1]}", flush=True)
    if args.root:
        gen["root"].append(root_gen(args.root))
        print(f"root again: ms per top frame {gen['root'][1]}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

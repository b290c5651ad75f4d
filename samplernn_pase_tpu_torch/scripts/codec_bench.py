"""K7 (the mu-law codec, ``ops/kernels/codec.py``) on the card: its time
in both L2 states, the launch floor, its compiled instructions and bounds.

    python -m samplernn_pase_tpu_torch.scripts.codec_bench [--root DIR]
                                                [--sass DIR]

For encode and decode at [128, 16384] (``generate()``'s request at
``bench.py``'s length) and [128, 1024] (one ``StreamPool`` chunk, 64 ms of
audio), on uniform floats in [-1.2, 1.2) and uniform levels from a seed,
``k7_times`` takes K7's own kernel time per launch (torch.profiler, by
kernel name):

* ``warm``: ``REPS`` back-to-back launches on one input (16.8 MB at the
  larger shape, which the 50 MB L2 holds);
* ``cold``: a ``FLUSH_BYTES`` buffer written before each launch;

beside this tree's plans (``codec.plan_for``) and the empty kernel
(``srnn_codec_floor``) on each plan's grid and on the grid of one block
per 256 columns of a row (K7's earlier design, one element a thread).
Then, from ``cuobjdump -sass`` of the built library, every loop of each
K7 kernel (a backward branch and its target) with its instruction and
MUFU counts, the registers ``ptxas -v`` reports, the SM clock
``nvidia-smi`` reads while K7 runs, and the bounds at [128, 16384]: bytes
(4 read and 4 written per element) over 3.35 TB/s; issue (instructions
per element x elements over 132 SMs x 4 schedulers x 32 lanes x the
clock); MUFU (per element x elements over 132 SMs x 16 a clock x the
clock), each loop's counts taken per element (over the elements a thread
takes per pass).  ``--sass DIR`` writes each tree's whole disassembly there.
``--root DIR`` also measures ``DIR``'s K7 (a checkout holding
``samplernn_pase_tpu_torch``, e.g. a ``git archive`` of the parent under
``build/``) in a subprocess, in the order root, this tree, this tree,
root.  The last line is one JSON object.  It needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from samplernn_pase_tpu_torch.scripts.gemm_ablation import device_us

PACKAGE = "samplernn_pase_tpu_torch"
SHAPES = ((128, 16384), (128, 1024))
Q = 256
REPS = 50
FLUSH_BYTES = 128 << 20
HBM_BYTES = 3.35e12          # bytes/s, H100 SXM data sheet
SMS, SCHEDULERS, LANES, MUFU_PER_CLOCK = 132, 4, 32, 16


def inputs(torch, rows: int, cols: int, seed: int = 12):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(rows, cols, device="cuda", generator=gen) * 2.4 - 1.2
    lv = torch.randint(0, Q, (rows, cols), device="cuda", generator=gen,
                       dtype=torch.int32)
    return x, lv


def k7_times(torch, fn, direction: str, grid=None) -> dict:
    """K7's own kernel time per launch of fn() (us): "warm" and "cold"
    (see the module's text), and with ``grid`` (blocks x, blocks y,
    threads) "floor", the empty kernel on that grid."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def cold():
        flush.fill_(1.0)
        fn()
    key = f"mu_law_{direction}"
    out = {"warm": device_us(fn, REPS, key=key),
           "cold": device_us(cold, 20, key=key)}
    del flush
    if grid is not None:
        out["floor"] = floor_us(torch, grid)
    return out


def time_k7(torch, codec) -> dict:
    """{direction: {"rows x cols": {"warm", "cold"}}} in us per launch."""
    out = {"encode": {}, "decode": {}}
    for rows, cols in SHAPES:
        x, lv = inputs(torch, rows, cols)
        out["encode"][f"{rows}x{cols}"] = k7_times(
            torch, lambda: codec.mu_law_encode(x, Q), "encode")
        out["decode"][f"{rows}x{cols}"] = k7_times(
            torch, lambda: codec.mu_law_decode(lv, Q), "decode")
    return out


def floor_us(torch, grid) -> float:
    """The empty kernel on ``grid`` (gx, gy, threads), us per launch."""
    from samplernn_pase_tpu_torch.ops.kernels import _build
    fn = _build.function("codec", "srnn_codec_floor", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    return device_us(lambda: fn(*grid, stream), REPS, key="codec_floor")


def parent_grid(rows: int, cols: int):
    """The grid of one block per 256 columns of a row (K7's earlier
    design, one element a thread)."""
    return (min(-(-cols // 256), 65535), min(rows, 65535), 256)


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
               / name)


def sass(lib: Path, dump_to: Path | None = None) -> dict:
    """{kernel: {"instructions", "mufu", "loops": [{"from", "to",
    "instructions", "mufu"}]}} of the K7 kernels in ``lib``'s SASS."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    if dump_to is not None:
        dump_to.parent.mkdir(parents=True, exist_ok=True)
        dump_to.write_text(text)
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "mu_law" not in name:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, op in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) <= addr:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
                loops.append({"from": hex(int(m.group(1), 16)),
                              "to": hex(addr), "instructions": len(body),
                              "mufu": sum("MUFU" in o for o in body)})
        out[name] = {"instructions": len(ins),
                     "mufu": sum("MUFU" in o for _, o in ins),
                     "elements_per_iteration": per_iteration(name),
                     "loops": loops}
    return out


def per_iteration(mangled: str) -> int:
    """Elements one thread takes per pass of a K7 kernel's item loop: W x
    VPT from the template arguments of ``mu_law_*_kernel<[TABLE,] W,
    VPT>`` (the last two); 1 for a kernel without them (K7's earlier
    design, one element a pass)."""
    args = [int(a) for a in re.findall(r"Li(\d+)E", mangled)]
    return args[-1] * args[-2] if len(args) >= 2 else 1


def registers(_build) -> dict:
    """{kernel: registers} from ``ptxas -v`` on a fresh build of codec.cu
    (the library itself is left as it is)."""
    out = _build.BUILD_DIR / "codec_ptxas.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = subprocess.run(_build._command("codec", out),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True, timeout=300).stdout
    regs, fn = {}, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        elif "Used" in line and "registers" in line and "mu_law" in fn:
            regs[fn] = int(line.split("Used")[1].split()[0])
    out.unlink(missing_ok=True)
    return regs


def sm_clock_mhz(torch, fn) -> float:
    """The SM clock that nvidia-smi reads while fn() runs back to back."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        for _ in range(200):
            fn()
    torch.cuda.synchronize()
    return float(proc.stdout.read().strip().splitlines()[0])


def item_loop(listing: dict, direction: str, plan) -> tuple[float, float]:
    """(instructions, MUFU) per element in the item loop of ``plan``'s
    kernel for ``direction``, from ``sass()``'s ``listing`` of the built
    library: its longest loop, over the elements a thread takes per pass.
    The loop holds the branches an item may skip (a row's scalar head and
    tail, a level outside [0, q)), so these are upper counts of what an
    item issues."""
    name = (f"mu_law_{direction}_kernelI"
            + (f"Lb{int(plan.table)}E" if direction == "decode" else "")
            + f"Li{plan.vec}ELi{plan.vpt}EE")
    found = [v for k, v in listing.items() if name in k]
    if len(found) != 1 or not found[0]["loops"]:
        raise RuntimeError(f"no single item loop of {name} in the SASS")
    loop = max(found[0]["loops"], key=lambda lp: lp["instructions"])
    per = found[0]["elements_per_iteration"]
    return loop["instructions"] / per, loop["mufu"] / per


def k7_bound_us(n: int, per_element: tuple[float, float],
                mhz: float) -> tuple[float, str, dict]:
    """(bound, "bytes" | "operations", the three bounds) of K7 over n
    elements, ``per_element`` from ``item_loop``, at the SM clock ``mhz``,
    in us."""
    b = bounds_us(n, *per_element, mhz)
    ops = max(b["issue"], b["mufu"])
    return max(b["bytes"], ops), ("bytes" if b["bytes"] >= ops
                                  else "operations"), b


def bounds_us(n: int, instructions: float, mufu: float, mhz: float) -> dict:
    """The three bounds of an elementwise pass over n elements, in us."""
    hz = mhz * 1e6
    return {"bytes": 8.0 * n / HBM_BYTES * 1e6,
            "issue": instructions * n / (SMS * SCHEDULERS * LANES * hz)
            * 1e6,
            "mufu": mufu * n / (SMS * MUFU_PER_CLOCK * hz) * 1e6}


def measure(dump_to: Path | None) -> dict:
    """This checkout's K7: times, SASS loops, registers."""
    import torch
    from samplernn_pase_tpu_torch.ops.kernels import _build
    from samplernn_pase_tpu_torch.ops.kernels import codec
    return {"us": time_k7(torch, codec),
            "sass": sass(_build._lib_path("codec"), dump_to),
            "registers": registers(_build)}


def root_measure(root: str, dump_to: Path | None) -> dict:
    """``measure()`` of the checkout ``root``, in a subprocess that runs
    this script (``-m``, from this tree) on ``root``'s package."""
    cmd = [sys.executable, "-m", f"{PACKAGE}.scripts.codec_bench",
           "--measure-only", "--port", root]
    if dump_to is not None:
        cmd += ["--sass", str(dump_to.parent)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=Path(__file__).resolve().parents[2])
    if proc.returncode != 0:
        raise RuntimeError(f"measuring {root} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose K7 to measure beside this tree's")
    ap.add_argument("--sass", default=None,
                    help="directory for the whole disassembly of each tree")
    ap.add_argument("--measure-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.port:
        # this tree's device_us (imported above) times the other
        # checkout's package, imported afresh from its root
        for name in [m for m in sys.modules if m.split(".")[0] == PACKAGE]:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(args.port))
    import torch
    if not torch.cuda.is_available():
        print("codec_bench: no CUDA device", file=sys.stderr)
        return 1
    sass_dir = Path(args.sass).resolve() if args.sass else None
    if args.measure_only:
        name = "root" if args.port else "tree"
        print(json.dumps(measure(sass_dir / f"{name}.sass" if sass_dir
                                 else None)))
        return 0
    from samplernn_pase_tpu_torch.ops.kernels import codec
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "runs": []}
    order = ["root", "tree", "tree", "root"] if args.root else ["tree"]
    for who in order:
        dump = sass_dir / f"{who}.sass" if sass_dir else None
        r = (root_measure(args.root, dump) if who == "root"
             else measure(dump))
        result["runs"].append({"who": who, **r})
        print(f"{who}: K7 us per launch {json.dumps(r['us'])}", flush=True)
    x, lv = inputs(torch, *SHAPES[0])
    mhz = {"encode": sm_clock_mhz(torch, lambda: codec.mu_law_encode(x, Q)),
           "decode": sm_clock_mhz(torch, lambda: codec.mu_law_decode(lv, Q))}
    result["sm_clock_mhz"] = mhz
    n = x.numel()
    for who in dict.fromkeys(order):
        r = next(x for x in result["runs"] if x["who"] == who)
        print(f"{who}: registers {r['registers']}")
        for k, v in r["sass"].items():
            d = "encode" if "encode" in k else "decode"
            per = v["elements_per_iteration"]
            for loop in v["loops"]:
                loop["bounds_us"] = bounds_us(
                    n, loop["instructions"] / per, loop["mufu"] / per,
                    mhz[d])
            print(f"{who}: {k}: {v['instructions']} instructions, "
                  f"{v['mufu']} MUFU, {per} elements per pass; loops "
                  f"{v['loops']}")
    listing = next(r for r in result["runs"] if r["who"] == "tree")["sass"]
    result["plans"], result["floor_us"], result["bounds_us"] = {}, {}, {}
    for rows, cols in SHAPES:
        xs, ls = inputs(torch, rows, cols)
        key = f"{rows}x{cols}"
        plans = {"encode": codec.plan_for(xs, ls, Q, False),
                 "decode": codec.plan_for(ls, xs, Q, True)}
        result["plans"][key] = {d: p._asdict() for d, p in plans.items()}
        result["floor_us"][key] = {
            "parent_grid": floor_us(torch, parent_grid(rows, cols)),
            **{f"{d}_plan": floor_us(torch, (p.blocks, 1, p.threads))
               for d, p in plans.items()}}
        result["bounds_us"][key] = {
            d: k7_bound_us(xs.numel(), item_loop(listing, d, p), mhz[d])
            for d, p in plans.items()}
    index = torch.cuda.current_device()
    result["resident"] = {d: codec.card(index, d == "decode")
                          for d in ("encode", "decode")}
    print(f"SM clock under K7 (MHz): {mhz}; (resident blocks per SM, SMs) "
          f"{result['resident']}; plans {result['plans']}; empty kernel us "
          f"{result['floor_us']}; bounds of the plans' item loops (us, "
          f"set by, bytes / issue / MUFU) {result['bounds_us']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1's tensor-core products in isolation on the card: builds
``scripts/k1_products.cu`` with ``nvcc`` into ``build/k1_products``
(apart from the kernel libraries of ``ops/kernels/_build``) and runs it.

    python -m samplernn_pase_tpu_torch.scripts.k1_products [--reps N]

The program multiplies four resident weight boxes in K1's layout (128
rows x 64 columns of bf16, 128-byte swizzle) with a 16-lane panel in each
of six forms (SS ``wgmma`` m64n16k16, RS ``wgmma`` with the weights from
``ldmatrix.trans``, ``mma.sync`` m16n8k16 at 16 and at 32 columns a
warp, the last with K1's mbarrier wait and release a box, released by
every thread or by one lane a warp), checks each form's sum against the
host's, and prints each form's SM clocks and us per box and per 16,384
multiply-adds against the floor of reading each box and panel once from
shared memory (160 clocks a box).  The card's name and power limit come
first; the last line is one JSON object.  It needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from samplernn_pase_tpu_torch.ops.kernels import _build

SOURCE = Path(__file__).resolve().with_suffix(".cu")
BINARY = _build.BUILD_DIR.parent / "k1_products"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4096,
                    help="products of the four boxes timed per form")
    args = ap.parse_args(argv)
    BINARY.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xptxas", "-v", "-o", str(BINARY), str(SOURCE)],
        capture_output=True, text=True, timeout=600)
    print(build.stdout + build.stderr, flush=True)
    if build.returncode != 0:
        print(f"k1_products: nvcc failed ({build.returncode})",
              file=sys.stderr)
        return build.returncode
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    return subprocess.run([str(BINARY), str(args.reps)],
                          timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())

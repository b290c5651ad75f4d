"""What the examples share: the command line and the device."""

from __future__ import annotations

import argparse


def parse(doc: str, default_out: str, argv=None):
    """(out path, device, on_card) from ``[--device DEV] [out]``: the card
    unless ``--device`` names another device."""
    from samplernn_pase_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=default_out)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    return args.out, dev, dev.type == "cuda"

"""End-to-end audio-quality smoke of the port, the twin of the repo's
``scripts/quality_smoke.py``.

Trains a small conditioned SampleRNN on a two-speaker synthetic sine
corpus through the whole training stack (codec, ``WavCorpus``,
``StreamBatcher``, ``Trainer`` with staged multi-step groups), then checks
that the model learned audio: each speaker's lane, seeded with the tail
of one of its utterances, must continue at that speaker's fundamental
(dominant frequency within 10% of 220 or 330 Hz) with an RMS above 0.05.

    python -m samplernn_pase_tpu_torch.scripts.quality_smoke        # card
    python -m samplernn_pase_tpu_torch.scripts.quality_smoke --tiny --device cpu

The full run is 512 wide in bf16 on the card; ``--tiny`` is 64 wide in
float32, small enough for the CPU.  Prints "quality smoke OK" and exits 0
on a pass, exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

SR = 16_000
F0S = (220.0, 330.0)       # speaker 0 / speaker 1 fundamentals
PRIME = 1088               # seed samples: lookback + 16 top frames


def build_corpus(n_per_spk=8, seconds=2.0, seed=0):
    from samplernn_pase_tpu_torch.data.dataset import (
        WavCorpus, _quantize_host)

    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    utts, speakers = [], []
    for spk, f0 in enumerate(F0S):
        for _ in range(n_per_spk):
            phase = rng.uniform(0, 2 * np.pi)
            x = (0.6 * np.sin(2 * np.pi * f0 * t + phase)
                 + 0.2 * np.sin(2 * np.pi * 2 * f0 * t + phase))
            utts.append(_quantize_host(x.astype(np.float32), 256))
            speakers.append(spk)
    return WavCorpus(utts, speakers=speakers, val_frac=0.0), utts


def dominant_hz(x):
    mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    f = np.fft.rfftfreq(len(x), 1 / SR)
    return float(f[mag.argmax()])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="smaller model in float32 (runs on the CPU)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.config import SampleRNNConfig, TrainConfig
    from samplernn_pase_tpu_torch.device import resolve_device
    from samplernn_pase_tpu_torch.ops.mulaw import mu_law_decode
    from samplernn_pase_tpu_torch.train import trainer as tr

    dev = resolve_device(args.device)
    dim = 64 if args.tiny else 512
    # the tiny model needs more passes to fit below the NLL gate
    epochs = args.epochs or (8 if args.tiny else 6)
    cfg = SampleRNNConfig(
        frame_sizes=(16, 4), dim=dim, embed_dim=64,
        cond_dim=16, cond_rate=256, n_speakers=2,
        compute_dtype="float32" if args.tiny else "bfloat16")
    corpus, utts = build_corpus()
    tcfg = TrainConfig(batch_size=8, seq_len=1024, lr=2e-3, epochs=epochs,
                       steps_per_call=4, shuffle=True)
    nlls = []

    class Cap(tr.Plugin):
        def on_step(self, trainer, step, metrics):
            nlls.append(metrics["nll_bits"])

    t = tr.Trainer(cfg, tcfg, corpus, plugins=[Cap()], device=dev)
    t.run()
    print(f"trained {t.global_step} steps: NLL {nlls[0]:.2f} -> "
          f"{nlls[-1]:.3f} bits")
    if not nlls[-1] < 1.0:
        print(f"QUALITY SMOKE FAILED: did not fit the corpus: "
              f"{nlls[-1]:.3f} bits", file=sys.stderr)
        return 1

    # continuation: seed lane 0 with the tail of a speaker-0 utterance and
    # lane 1 with a speaker-1 one, primed through the teacher-forced model
    # (generate.prime: the tiers' states and the sample window, as the
    # CLI's --seed-wav); each must keep its speaker's pitch
    seed_levels = np.stack([utts[0][-PRIME:], utts[8][-PRIME:]])
    speakers = torch.tensor([0, 1], dtype=torch.int32)
    states, hist = gen.prime(t.params, cfg, seed_levels, speakers=speakers,
                             device=dev)
    levels = gen.generate_levels(
        t.params, cfg, 2, 4096, temperature=0.85, seed=1, hist=hist,
        initial_states=states, speakers=speakers, device=dev)
    wav = mu_law_decode(levels.cpu(), 256).numpy()
    ok = True
    for lane, f0 in enumerate(F0S):
        got = dominant_hz(wav[lane])
        rms = float(np.sqrt((wav[lane] ** 2).mean()))
        good = abs(got - f0) < 0.1 * f0 and rms > 0.05
        ok &= good
        print(f"lane {lane} (spk {lane}, f0 {f0:.0f} Hz): generated "
              f"dominant {got:.1f} Hz, rms {rms:.3f} "
              f"{'OK' if good else 'FAIL'}")
    if not ok:
        print("QUALITY SMOKE FAILED", file=sys.stderr)
        return 1
    print("quality smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

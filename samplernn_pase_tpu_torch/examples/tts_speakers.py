"""Multi-speaker TTS example: train a speaker-conditioned SampleRNN on a
two-speaker synthetic corpus, generate audio per speaker, and continue a
waveform with ``generate.prime``; no datasets needed.

    python -m samplernn_pase_tpu_torch.examples.tts_speakers [--device cpu] [out_dir]

On the card the model is the reference's example's (dim 256, bf16, 4
epochs); with ``--device cpu`` a dim-32 float32 model trains for 1 epoch
on shorter utterances.  The CLI equivalents on a corpus laid out as
``speaker/utt.wav``::

    python -m samplernn_pase_tpu_torch.cli train --dataset DIR --exp-dir EXP \\
        --cond_dim 16 --cond_rate 256 ...      # + n_speakers via config
    python -m samplernn_pase_tpu_torch.cli generate --ckpt EXP --out WAVS \\
        --speaker 1 [--seed-wav prompt.wav]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

SR = 16_000
F0S = (220.0, 330.0)   # speaker 0 / speaker 1 fundamentals


def build_corpus(n_per_spk=8, seconds=2.0, seed=0):
    """Two speakers of sines at their fundamentals (and an octave):
    (corpus, utterances as levels)."""
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


def main(argv=None):
    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.config import SampleRNNConfig, TrainConfig
    from samplernn_pase_tpu_torch.examples._common import parse
    from samplernn_pase_tpu_torch.ops.audio_io import write_wav
    from samplernn_pase_tpu_torch.train import trainer as tr

    out, dev, card = parse(__doc__, "example_tts_out", argv)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = SampleRNNConfig(
        frame_sizes=(16, 4), dim=256 if card else 32, embed_dim=64,
        cond_dim=16, cond_rate=256, n_speakers=2,
        compute_dtype="bfloat16" if card else "float32")
    corpus, utts = build_corpus(seconds=2.0 if card else 0.5)
    tcfg = TrainConfig(batch_size=8, seq_len=1024 if card else 256,
                       lr=2e-3, epochs=4 if card else 1, steps_per_call=4,
                       shuffle=True)
    length = SR // 2 if card else 1024

    print("training speaker-conditioned model...")
    nlls = []

    class Cap(tr.Plugin):
        def on_step(self, trainer, step, metrics):
            nlls.append(metrics["nll_bits"])

    t = tr.Trainer(cfg, tcfg, corpus, [Cap()], device=dev)
    t.run()
    print(f"  {t.global_step} steps: NLL {nlls[0]:.2f} -> {nlls[-1]:.3f} "
          "bits")

    # one sequence per speaker id: the learned speaker embedding steers
    # the generated pitch
    print("generating one sequence per speaker...")
    spk = np.asarray([0, 1], np.int32)
    wav = gen.generate(t.params, cfg, n_seqs=2, length=length,
                       temperature=0.85, seed=1, speakers=spk,
                       device=dev).cpu().numpy()
    for s in range(2):
        write_wav(out / f"speaker{s}.wav", wav[s], SR)

    # audio continuation: prime the decoder state on a corpus utterance,
    # then generate; the continuation carries the prompt's recent past
    print("continuing a real waveform (generate.prime)...")
    half = len(utts) // 2
    seed_lv = np.stack([utts[0][-4096:], utts[half][-4096:]])
    states, hist = gen.prime(t.params, cfg, seed_lv, speakers=spk,
                             device=dev)
    levels = gen.generate_levels(t.params, cfg, 2, length, temperature=0.85,
                                 seed=2, initial_states=states, hist=hist,
                                 speakers=spk, device=dev)
    cont = gen.decode_waveform(levels, cfg).cpu().numpy()
    for s in range(2):
        write_wav(out / f"continuation_spk{s}.wav", cont[s], SR)
    print(f"wrote 4 wavs to {out}/")


if __name__ == "__main__":
    sys.exit(main())

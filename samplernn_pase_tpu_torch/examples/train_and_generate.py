"""End-to-end example: train a small SampleRNN on a synthetic corpus,
then generate audio; no datasets or checkpoints needed.

    python -m samplernn_pase_tpu_torch.examples.train_and_generate [--device cpu] [out_dir]

On the card this trains the reference's example model (dim 256, bf16,
6 epochs over 4 utterances of 16,384 samples) and writes two 2 s wavs;
with ``--device cpu`` a dim-32 float32 model trains for 2 epochs over
shorter utterances.  The CLI does the same on real wav folders
(``python -m samplernn_pase_tpu_torch.cli train ...``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def main(argv=None):
    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.config import SampleRNNConfig, TrainConfig
    from samplernn_pase_tpu_torch.data.dataset import synthetic_corpus
    from samplernn_pase_tpu_torch.examples._common import parse
    from samplernn_pase_tpu_torch.ops.audio_io import write_wav
    from samplernn_pase_tpu_torch.train import trainer as tr

    out, dev, card = parse(__doc__, "example_out", argv)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    if card:
        cfg = SampleRNNConfig(frame_sizes=(16, 4), dim=256, embed_dim=64)
        corpus = synthetic_corpus(n_utts=4, length=16384, seed=0)
        tcfg = TrainConfig(batch_size=4, seq_len=1024, lr=2e-3, epochs=6,
                           log_every_steps=20)
        length = 32000
    else:
        cfg = SampleRNNConfig(frame_sizes=(16, 4), dim=32, embed_dim=16,
                              compute_dtype="float32")
        corpus = synthetic_corpus(n_utts=4, length=4096, seed=0)
        tcfg = TrainConfig(batch_size=4, seq_len=256, lr=2e-3, epochs=2,
                           log_every_steps=20)
        length = 2048

    print("training...")
    losses = []

    class Cap(tr.Plugin):
        def on_step(self, trainer, step, metrics):
            losses.append(metrics["nll_bits"])

    t = tr.Trainer(cfg, tcfg, corpus, [Cap()], device=dev)
    t.run()
    print(f"NLL: {np.mean(losses[:4]):.2f} -> {np.mean(losses[-4:]):.2f} "
          f"bits/sample over {len(losses)} steps")

    print("generating...")
    wav = gen.generate(t.params, cfg, n_seqs=2, length=length,
                       temperature=0.9, seed=0, device=dev).cpu().numpy()
    for i in range(2):
        p = out / f"sample_{i}.wav"
        write_wav(p, wav[i])
        print("wrote", p)


if __name__ == "__main__":
    sys.exit(main())

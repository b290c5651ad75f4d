"""Single-stream serving: enqueue-ahead decoding with
``StreamingGenerator``.

``emit()`` returns a device tensor as soon as the work is queued; reading
it (``.cpu()``) waits for it.  A serving loop that queues chunk t+1
before reading chunk t overlaps the host's launches with the card's work
and with playback.  Also shown: ``chunks_per_call=K`` (one call generates
K chunks into a lookahead buffer) for callers that must block per chunk,
and a conditioned stream (``set_cond``) equal to a one-shot decode.

    python -m samplernn_pase_tpu_torch.examples.serving_stream [--device cpu] [out.wav]

The model is small (dim 128, float32) so the example runs anywhere; the
flagship (frame_sizes (16, 4), dim 1024) uses the same API.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(argv=None):
    import torch

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    from samplernn_pase_tpu_torch.examples._common import parse
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.audio_io import write_wav

    out_path, dev, card = parse(__doc__, "serving_demo.wav", argv)
    cfg = SampleRNNConfig(frame_sizes=(16, 4), dim=128, embed_dim=64,
                          compute_dtype="float32")
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    chunk = cfg.lookback * (16 if card else 4)   # 1,024 samples = 64 ms
    n_chunks = 8 if card else 4

    sg = gen.StreamingGenerator(params, cfg, n_seqs=1, temperature=0.95,
                                seed=1, device=dev)

    # ---- enqueue-ahead loop: keep one chunk in flight -----------------
    pending = sg.emit(chunk)           # queue chunk 0 (returns at once)
    audio = []
    t0 = time.perf_counter()
    for _ in range(n_chunks - 1):
        nxt = sg.emit(chunk)           # queue t+1 before reading t
        audio.append(pending.cpu().numpy())   # "playback" reads chunk t
        pending = nxt
    audio.append(pending.cpu().numpy())
    dt = (time.perf_counter() - t0) / n_chunks * 1e3
    print(f"enqueue-ahead: {dt:.1f} ms per {chunk} samples "
          f"({chunk / 16_000 * 1e3:.0f} ms of audio) on {dev}")

    # ---- buffered mode: one call per 4 chunks -------------------------
    sg2 = gen.StreamingGenerator(params, cfg, n_seqs=1, temperature=None,
                                 chunks_per_call=4, device=dev)
    buffered = [sg2.emit(chunk).cpu().numpy() for _ in range(4)]
    assert all(b.shape == (1, chunk) for b in buffered)

    # ---- conditioned TTS stream: the whole cond stream up front -------
    # set_cond attaches the utterance's embedding stream; the generator
    # advances through it with its sample cursor, so chunk boundaries need
    # not align to cond_rate and buffered lookahead works conditioned.
    # Greedy chunked output equals the one-shot decode.
    ccfg = SampleRNNConfig(frame_sizes=(16, 4), dim=128, embed_dim=64,
                           cond_dim=32, cond_rate=160,
                           compute_dtype="float32")
    cparams = samplernn.init_params(torch.Generator().manual_seed(2), ccfg,
                                    dev)
    total = chunk * 4
    emb = np.random.default_rng(3).normal(
        size=(-(-total // ccfg.cond_rate), 32)).astype(np.float32)
    sg3 = gen.StreamingGenerator(cparams, ccfg, n_seqs=1, temperature=None,
                                 chunks_per_call=2, device=dev)
    sg3.set_cond(emb)
    cond_stream = np.concatenate([sg3.emit(chunk).cpu().numpy()
                                  for _ in range(4)], axis=1)
    oneshot = gen.generate_levels(
        cparams, ccfg, 1, total, temperature=None,
        cond=np.broadcast_to(emb[None], (1, *emb.shape)),
        device=dev).cpu().numpy()
    assert np.array_equal(cond_stream, oneshot)
    print("conditioned stream == one-shot decode: OK")

    levels = torch.from_numpy(np.concatenate(audio, axis=1)).to(dev)
    wav = gen.decode_waveform(levels, cfg)[0].cpu().numpy()
    write_wav(out_path, wav, 16_000)
    print(f"wrote {len(wav) / 16_000:.2f}s of audio to {out_path}")


if __name__ == "__main__":
    sys.exit(main())

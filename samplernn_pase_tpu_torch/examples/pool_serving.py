"""Multi-stream TTS serving with ``serve.StreamPool``: lanes join and
leave a running batch without stopping it.

One resident batch of decode lanes advances in one generation call per
chunk (continuous batching with static shapes and recycled slots); each
lane carries its own conditioning stream, speaker, noise key and
lifecycle.  The example runs a small conditioned model, staggers three
requests across chunk boundaries (one continuing an audio prompt, one
sampled with a pinned stream key, one fed its conditioning in pieces
with ``extend_cond``, the streaming-encoder pattern) and checks the
pinned lane against a solo B=1 generator: they must be identical (lanes
are independent in the model and the kernels, noise is per lane, and
chunks need only be lookback multiples).

    python -m samplernn_pase_tpu_torch.examples.pool_serving [--device cpu] [out.wav]

Size ``n_lanes`` to the batch the card serves well (``PERF.md`` times
128-lane pools on the H100) and drive the loop enqueue-ahead:
``pool.emit()`` returns as soon as the chunk is queued.
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    import torch

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.config import SampleRNNConfig
    from samplernn_pase_tpu_torch.examples._common import parse
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.ops.audio_io import write_wav
    from samplernn_pase_tpu_torch.ops.kernels.noise import int_key
    from samplernn_pase_tpu_torch.serve import StreamPool

    out_path, dev, _ = parse(__doc__, "pool_demo.wav", argv)
    cfg = SampleRNNConfig(frame_sizes=(16, 4), dim=128, embed_dim=64,
                          cond_dim=32, cond_rate=64, n_speakers=4,
                          compute_dtype="float32")
    params = samplernn.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
    # any lookback multiple works: cond_rate 64 does not divide 192; each
    # lane's sub-row phase is resolved in the kernel
    chunk = cfg.lookback * 3                            # 192 samples
    rng = np.random.default_rng(0)

    def fake_utterance_embedding(n_chunks):
        frames = n_chunks * chunk // cfg.cond_rate
        return rng.normal(size=(frames, cfg.cond_dim)).astype(np.float32)

    pool = StreamPool(params, cfg, n_lanes=4, temperature=0.9, device=dev)

    # request A arrives (sampled, key pinned so that a replica could
    # reproduce it); B arrives one chunk later with an audio prompt
    emb_a, emb_b = fake_utterance_embedding(4), fake_utterance_embedding(3)
    prompt = rng.integers(0, cfg.q_levels, (2 * cfg.lookback,), np.int64)
    key_a = int_key(42)
    # A starts with only the rows its first chunk needs (192 samples /
    # cond_rate 64 = rows 0-2, and one row ahead); the encoder streams the
    # rest in before chunk 2 reads them
    a = pool.start(cond=emb_a[:4], speaker=1, stream_key=key_a)
    chunks = [pool.emit(chunk).cpu().numpy()]
    b = pool.start(cond=emb_b, speaker=3, seed_levels=prompt)
    pool.extend_cond(a, emb_a[4:])
    chunks += [pool.emit(chunk).cpu().numpy() for _ in range(2)]
    pool.stop(b)                           # B's request completed
    c = pool.start(cond=emb_a, speaker=0)  # the slot is reused at once
    chunks += [pool.emit(chunk).cpu().numpy()]
    out = np.concatenate(chunks, axis=1)

    # the pinned lane equals its solo B=1 generator: the same stream key
    # gives the same sampled audio, whatever the pool's churn and whenever
    # the conditioning rows arrived
    solo = gen.StreamingGenerator(params, cfg, 1, temperature=0.9,
                                  stream_keys=key_a, device=dev)
    solo.set_cond(emb_a)
    want_a = np.concatenate(
        [solo.emit(chunk, speakers=np.asarray([1], np.int32)).cpu().numpy()
         for _ in range(4)], axis=1)[0]
    np.testing.assert_array_equal(out[a], want_a)
    print("sampled pool lane A == solo generator (same stream key): OK")
    assert c == b, "B's slot should be recycled"

    wav = gen.decode_waveform(torch.from_numpy(out[a]).to(dev)[None],
                              cfg)[0].cpu().numpy()
    write_wav(out_path, wav, 16_000)
    print(f"wrote {len(wav) / 16_000:.2f}s (lane A) to {out_path}")


if __name__ == "__main__":
    sys.exit(main())

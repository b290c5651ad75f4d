"""The command line, as ``samplernn_pase_tpu.cli``: the reference's six
verbs with the same flags.

    python -m samplernn_pase_tpu_torch.cli train    --dataset DIR --exp-dir EXP ...
    python -m samplernn_pase_tpu_torch.cli extract  --dataset DIR --out DIR ...
    python -m samplernn_pase_tpu_torch.cli generate --ckpt EXP --out DIR ...
    python -m samplernn_pase_tpu_torch.cli evaluate --ckpt EXP --dataset DIR
    python -m samplernn_pase_tpu_torch.cli stream   --ckpt EXP --out X.wav
    python -m samplernn_pase_tpu_torch.cli serve    --ckpt EXP --out DIR --jobs M.json

--config loads a full JSON preset (configs/*.json) and flags override it.
``--platform {auto,cuda,cpu}`` picks the device once, before any verb
runs: ``auto`` and ``cuda`` need a CUDA device and exit naming
``--platform cpu`` when there is none; every module a verb calls gets
that device explicitly.  ``main`` turns TF32 off for the process (float32
matmuls and cuDNN convolutions at full precision, as the reference runs
at ``highest``).

An experiment directory holds ``config.json``, ``metrics.jsonl`` and
``ckpt/`` in the port's torch checkpoint format
(``train.checkpoint.CheckpointManager``); a reference (orbax) experiment
is carried over with ``convert.experiment_from_jax``.  ``--seed`` and
``--stream-key`` keep their meaning: ``--stream-key N`` pins the stream's
noise to the words of the reference's ``PRNGKey(N)``
(``noise.int_key``), but the port draws from Philox, so sampled audio is
not the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np


def _add_model_flags(p):
    p.add_argument("--frame_sizes", type=int, nargs="+", default=None)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--n_rnn", type=int, default=None)
    p.add_argument("--rnn_type", choices=["gru", "lstm"], default=None)
    p.add_argument("--q_levels", type=int, default=None)
    p.add_argument("--embed_dim", type=int, default=None)
    p.add_argument("--cond_dim", type=int, default=None)
    p.add_argument("--cond_rate", type=int, default=None)
    p.add_argument("--rnn_layers", dest="n_rnn_alias", type=int,
                   default=None, help="alias of --n_rnn")
    p.add_argument("--weight_norm", action="store_const", const=True,
                   default=None)
    p.add_argument("--codec", choices=["mulaw", "linear"], default=None)
    p.add_argument("--remat", action="store_const", const=True,
                   default=None)


def _override(cfg, args, fields):
    kw = {f: getattr(args, f) for f in fields
          if getattr(args, f, None) is not None}
    if not kw:
        return cfg
    if "frame_sizes" in kw:
        kw["frame_sizes"] = tuple(kw["frame_sizes"])
    # --dim on a config whose mlp_hidden tracked the old dim: keep it
    # tracking (mlp_hidden must always equal dim; 0 = "follow dim")
    if "dim" in kw and getattr(cfg, "mlp_hidden", None) == getattr(
            cfg, "dim", None):
        kw.setdefault("mlp_hidden", 0)
    return dataclasses.replace(cfg, **kw)


def _load_exp(args):
    from samplernn_pase_tpu_torch import config as C
    if args.config:
        exp = C.load_config(args.config)
    elif getattr(args, "preset", None):
        exp = C.preset(args.preset)
    else:
        exp = C.ExperimentConfig()
    if getattr(args, "n_rnn_alias", None) is not None:
        args.n_rnn = args.n_rnn_alias
    model = _override(exp.model, args, [
        "frame_sizes", "dim", "n_rnn", "rnn_type", "q_levels", "embed_dim",
        "cond_dim", "cond_rate", "weight_norm", "codec", "remat"])
    train = _override(exp.train, args, [
        "batch_size", "seq_len", "lr", "lr_schedule", "epochs", "seed",
        "exp_dir"])
    return dataclasses.replace(exp, model=model, train=train)


def _or(v, default):
    """A flag's value, or ``default`` when it was not given: an explicit
    None test, since 0 is meaningful (``--temperature 0`` is greedy)."""
    return v if v is not None else default


def _chunk_samples(args, exp):
    """``--chunk-ms`` (default 64) in samples, rounded up to a lookback
    multiple."""
    lb = exp.model.lookback
    sr = exp.generate.sample_rate
    return -(-int(sr * (args.chunk_ms or 64) / 1000) // lb) * lb


def _on(dev, tree):
    from samplernn_pase_tpu_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def _restore(args):
    """The experiment under ``--ckpt``: (exp, the restored checkpoint at
    ``_pick_step``'s step), or exit when it has none."""
    from samplernn_pase_tpu_torch import config as C
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager

    exp_dir = Path(args.ckpt)
    exp = C.load_config(exp_dir / "config.json")
    mgr = CheckpointManager(exp_dir / "ckpt")
    restored = mgr.restore(step=_pick_step(args, mgr))
    if restored is None:
        sys.exit(f"no checkpoint under {exp_dir}/ckpt")
    return exp, restored


def cmd_train(args):
    from samplernn_pase_tpu_torch import config as C
    from samplernn_pase_tpu_torch.data.dataset import (
        WavCorpus, synthetic_corpus)
    from samplernn_pase_tpu_torch.train import trainer as tr
    from samplernn_pase_tpu_torch.train.checkpoint import CheckpointManager
    from samplernn_pase_tpu_torch.train.metrics import MetricsWriter

    dev = args.device
    exp = _load_exp(args)
    tcfg = exp.train
    if args.dataset:
        corpus = WavCorpus.from_folder(
            args.dataset, exp.model.q_levels,
            cond_dir=args.cond_dir or None, codec=exp.model.codec,
            sample_rate=tcfg.sample_rate)
    else:
        print("[train] no --dataset; using synthetic corpus", file=sys.stderr)
        corpus = synthetic_corpus(q_levels=exp.model.q_levels)

    joint_kwargs = {}
    if args.joint:
        # end-to-end PASE + SampleRNN (config 4): the same plugin loop as
        # plain training — validation, checkpoint cadence + --resume,
        # conditioned generation artifacts, steps_per_call
        pase_cfg = exp.pase or C.PASEConfig()
        model = exp.model
        if not model.cond_dim:
            model = dataclasses.replace(model, cond_dim=pase_cfg.emb_dim,
                               cond_rate=pase_cfg.decimation)
        exp = dataclasses.replace(exp, model=model, pase=pase_cfg)
        pase_params = bn_state = None
        if args.pase_ckpt:
            from samplernn_pase_tpu_torch.models import pase as pase_mod
            pase_params, bn_state, _ = pase_mod.load_torch_pase(
                args.pase_ckpt, pase_cfg)
        joint_kwargs = dict(freeze_pase=args.freeze_pase,
                            pase_params=pase_params, bn_state=bn_state)

    exp_dir = Path(tcfg.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    (exp_dir / "config.json").write_text(C.to_json(exp))
    writer = MetricsWriter(exp_dir / "metrics.jsonl")
    mgr = CheckpointManager(exp_dir / "ckpt", tcfg.max_to_keep)

    plugins = [
        tr.LoggerPlugin(writer, tcfg.log_every_steps),
        tr.ValidationPlugin(writer, tcfg.val_every_steps),
        tr.CheckpointPlugin(mgr, tcfg.ckpt_every_steps),
    ]
    if tcfg.generate_every_steps:
        # conditioned models emit conditioned samples: cached PASE streams
        # from the corpus when available; n_speakers models default to
        # one sequence per speaker inside the plugin
        gen_kw = {}
        if exp.model.cond_dim and corpus.conditioning is not None:
            from samplernn_pase_tpu_torch.generate import fit_cond_stream
            need = -(-tcfg.generate_length // exp.model.cond_rate)
            idx = (corpus.val_idx or corpus.train_idx)[:2]
            gen_kw["cond"] = np.stack([fit_cond_stream(
                corpus.conditioning[i], need) for i in idx])
        plugins.append(tr.GeneratorPlugin(
            exp_dir / "samples", tcfg.generate_every_steps,
            length=tcfg.generate_length, sample_rate=tcfg.sample_rate,
            **gen_kw))
    if args.joint:
        from samplernn_pase_tpu_torch.train.joint import JointTrainer
        t = JointTrainer(exp.model, exp.pase, tcfg, corpus, plugins,
                         device=dev, **joint_kwargs)
    else:
        t = tr.Trainer(exp.model, tcfg, corpus, plugins, device=dev)
    if args.resume:
        if t.restore(mgr):
            print(f"[train] resumed at step {t.global_step}",
                  file=sys.stderr)
    t.run(_or(args.epochs, tcfg.epochs))
    writer.close()
    mgr.close()


def cmd_extract(args):
    import torch

    from samplernn_pase_tpu_torch.config import PASEConfig
    from samplernn_pase_tpu_torch.extract import extract_to_dir
    from samplernn_pase_tpu_torch.models import pase as pase_mod

    cfg = PASEConfig()
    if getattr(args, "ckpt", None):
        # the adapted encoder of a `train --joint` experiment
        exp, restored = _restore(args)
        payload = restored["params"]
        if not (isinstance(payload, dict) and "joint" in payload):
            sys.exit(f"{args.ckpt} is not a --joint experiment checkpoint")
        cfg = exp.pase or cfg
        params, bn_state, _ = pase_mod.absorb_legacy_bias(
            payload["joint"]["pase"], payload["bn"])
        print(f"[extract] using jointly-trained encoder from {args.ckpt} "
              f"(step {restored['step']})", file=sys.stderr)
    elif args.pase_ckpt:
        params, bn_state, report = pase_mod.load_torch_pase(
            args.pase_ckpt, cfg)
        print(f"[extract] imported {len(report['loaded'])} tensors, "
              f"skipped {len(report['skipped'])}", file=sys.stderr)
    else:
        params, bn_state = pase_mod.init_pase(
            torch.Generator().manual_seed(0), cfg, args.device)
        print("[extract] no --pase-ckpt: random-init encoder",
              file=sys.stderr)
    paths = extract_to_dir(
        params, bn_state, cfg, args.dataset, args.out,
        _or(args.batch_size, 16),
        device=args.device)
    print(f"[extract] wrote {len(paths)} embedding files to {args.out}",
          file=sys.stderr)


def _split_restored(restored, dev):
    """Unpack a checkpoint payload onto ``dev``: plain Trainer runs carry
    model params; --joint runs carry {"joint": {"srnn", "pase"}, "bn"} —
    the SampleRNN half drives generation/evaluation and the adapted PASE
    encoder is available for conditioning."""
    from samplernn_pase_tpu_torch.models.pase import absorb_legacy_bias
    p = restored["params"]
    if isinstance(p, dict) and "joint" in p:
        # a joint checkpoint whose conv blocks still carry a bias: fold it
        # into the running mean (eval output unchanged) before handing the
        # encoder out
        pp, bn, _ = absorb_legacy_bias(p["joint"]["pase"], p["bn"])
        return _on(dev, p["joint"]["srnn"]), _on(dev, (pp, bn))
    return _on(dev, p), None


def _embed_wav(path, pase_cfg, encoder, pase_ckpt, dev):
    """One wav -> PASE embedding [frames, D] float32 numpy using (in
    priority order) the jointly-trained encoder from the checkpoint, a
    torch PASE ckpt, or a random-init encoder (with a warning)."""
    import torch

    from samplernn_pase_tpu_torch.extract import extract_embeddings
    from samplernn_pase_tpu_torch.models import pase as pase_mod
    from samplernn_pase_tpu_torch.ops.audio_io import read_wav, resample

    if encoder is not None:
        pase_params, bn_state = encoder
        src = "jointly-trained encoder"
    elif pase_ckpt:
        pase_params, bn_state, _ = pase_mod.load_torch_pase(
            pase_ckpt, pase_cfg)
        src = f"torch ckpt {pase_ckpt}"
    else:
        pase_params, bn_state = pase_mod.init_pase(
            torch.Generator().manual_seed(0), pase_cfg, dev)
        src = "RANDOM-INIT encoder (pass --pase-ckpt for real features)"
    x, sr = read_wav(path)
    if sr != pase_cfg.sample_rate:
        x = resample(x, sr, pase_cfg.sample_rate)
    emb = extract_embeddings(pase_params, bn_state, pase_cfg, [x],
                             device=dev)[0]
    print(f"[generate] conditioned on {path} via {src} "
          f"({emb.shape[0]} frames)", file=sys.stderr)
    return emb


def _load_seed_wav(path, exp, sr, joint_encoder, pase_ckpt, dev, *,
                   warn_tag, warn_if_unembeddable=True):
    """Load a seed waveform for audio continuation (one definition for
    the generate/stream/serve verbs): resample to the model rate,
    quantize with the model codec on the host, and — for conditioned
    models with a usable encoder — embed it, so priming warms the state
    under the seed's OWN conditioning, as teacher forcing during training
    would have.  Returns ``(levels [L] int32, cond [frames, D] | None)``."""
    from samplernn_pase_tpu_torch import config as C
    from samplernn_pase_tpu_torch.data.dataset import _quantize_host
    from samplernn_pase_tpu_torch.ops.audio_io import read_wav, resample

    x, in_sr = read_wav(path)
    if in_sr != sr:
        x = resample(x, in_sr, sr)
    levels = _quantize_host(x, exp.model.q_levels, exp.model.codec)
    cond = None
    if exp.model.cond_dim:
        if joint_encoder is not None or pase_ckpt:
            cond = _embed_wav(path, exp.pase or C.PASEConfig(),
                              joint_encoder, pase_ckpt, dev)
        elif warn_if_unembeddable:
            # priming is conditioned but the seed can't be embedded —
            # the warmed state won't see conditioning
            print(f"[warn] {warn_tag}: no PASE encoder available to "
                  "embed the seed (pass --pase-ckpt); priming without "
                  "external conditioning", file=sys.stderr)
    return levels, cond


def _cond_arg(args, exp, joint_encoder, dev):
    """The --cond / --cond-wav embedding [frames, cond_dim], or None;
    exits when the model has no conditioning or the shape is wrong."""
    from samplernn_pase_tpu_torch import config as C
    if not (args.cond or args.cond_wav):
        return None
    if not (exp.model.cond_dim and exp.model.cond_rate):
        sys.exit("--cond/--cond-wav require a model trained with "
                 "conditioning (cond_dim/cond_rate); this checkpoint "
                 "has none")
    if args.cond:
        emb = np.load(args.cond)
    else:
        emb = _embed_wav(args.cond_wav, exp.pase or C.PASEConfig(),
                         joint_encoder, args.pase_ckpt, dev)
    if emb.ndim != 2 or emb.shape[1] != exp.model.cond_dim:
        sys.exit(f"--cond{'-wav' if args.cond_wav else ''}: expected "
                 f"[frames, {exp.model.cond_dim}] embedding, got "
                 f"{emb.shape}")
    return emb


def _speaker_arg(speaker, exp, n):
    """--speaker as int32 [n] ids, or None; exits on a model without
    n_speakers or an id out of range."""
    if speaker is None:
        return None
    if not exp.model.n_speakers:
        sys.exit("--speaker requires a model trained with n_speakers; "
                 "this checkpoint has none")
    if not 0 <= speaker < exp.model.n_speakers:
        sys.exit(f"--speaker {speaker} out of range "
                 f"[0, {exp.model.n_speakers})")
    return np.full((n,), speaker, np.int32)


def _write_levels(path, levels, cfg, sr, dev):
    """Levels [T] (numpy or tensor) -> a wav, decoded on ``dev`` (K7 on
    the card)."""
    import torch

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.ops.audio_io import write_wav
    wav = gen.decode_waveform(torch.as_tensor(levels).to(dev), cfg)
    write_wav(path, wav.cpu().numpy(), sr)
    return wav.shape[-1]


def cmd_generate(args):
    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.ops.audio_io import write_wav

    dev = args.device
    exp, restored = _restore(args)
    print(f"[generate] checkpoint step {restored['step']}",
          file=sys.stderr)
    params, joint_encoder = _split_restored(restored, dev)
    gcfg = exp.generate
    n = _or(args.n_seqs, gcfg.n_seqs)
    length = _or(args.length, gcfg.length)
    cond = None
    emb = _cond_arg(args, exp, joint_encoder, dev)
    if emb is not None:
        # clamp-extend/trim to exactly cover the generation (same
        # contract as GeneratorPlugin — see generate.fit_cond_stream)
        emb = gen.fit_cond_stream(emb, -(-length // exp.model.cond_rate))
        cond = np.repeat(emb[None], n, axis=0)
    speakers = _speaker_arg(args.speaker, exp, n)
    prime_kw = {}
    if args.seed_wav:
        # audio continuation: warm the decoder state on a seed waveform
        # so the generated audio carries on from it (generate.prime).
        # One lane is primed and its state copied to all n — the lanes
        # start identical and diverge through sampling.  The copies are
        # contiguous: the kernels read every lane's rows.
        seed_lv, pc = _load_seed_wav(
            args.seed_wav, exp, gcfg.sample_rate, joint_encoder,
            args.pase_ckpt, dev, warn_tag="--seed-wav",
            warn_if_unembeddable=cond is not None)
        states, hist = gen.prime(
            params, exp.model, seed_lv[None],
            cond=None if pc is None else pc[None],
            speakers=None if speakers is None else speakers[:1], device=dev)
        states = tuple(s.expand(*s.shape[:-2], n, s.shape[-1]).contiguous()
                       for s in states)
        hist = hist.expand(n, hist.shape[1]).contiguous()
        prime_kw = {"initial_states": states, "hist": hist}
        print(f"[generate] primed on {len(seed_lv)} seed samples from "
              f"{args.seed_wav}", file=sys.stderr)
    levels = gen.generate_levels(
        params, exp.model, n, length, _or(args.temperature, gcfg.temperature),
        _or(args.seed, gcfg.seed), cond=cond, speakers=speakers, device=dev,
        **prime_kw)
    wav = gen.decode_waveform(levels, exp.model).cpu().numpy()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_wav(out / f"gen_{i:03d}.wav", wav[i], gcfg.sample_rate)
    print(f"[generate] wrote {n} wavs to {out}", file=sys.stderr)


def cmd_stream(args):
    """Chunked streaming synthesis: decode chunk-by-chunk through
    StreamingGenerator (state carried across chunks — the serving path),
    report per-chunk latency, write one wav."""
    import time

    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.ops.kernels.noise import int_key
    from samplernn_pase_tpu_torch.serve import host_copy, host_wait

    dev = args.device
    exp, restored = _restore(args)
    params, joint_encoder = _split_restored(restored, dev)
    gcfg = exp.generate
    sr = gcfg.sample_rate
    chunk = _chunk_samples(args, exp)
    n_chunks = max(1, -(-int(sr * (args.seconds or 2.0)) // chunk))
    temp = _or(args.temperature, gcfg.temperature)
    cond = None
    emb = _cond_arg(args, exp, joint_encoder, dev)
    if emb is not None:
        # one stream covering the whole utterance; the generator advances
        # through it chunk by chunk (clamp-extends past the end)
        cond = gen.fit_cond_stream(
            emb, -(-(n_chunks * chunk) // exp.model.cond_rate))
    elif exp.model.cond_dim and not exp.model.n_speakers:
        # a PASE-conditioned model decoded without its stream feeds a
        # distribution it never saw (same hazard evaluate warns about)
        print("[warn] this checkpoint was trained with external "
              "conditioning (cond_dim set); pass --cond/--cond-wav to "
              "stream conditioned synthesis — decoding UNCONDITIONED",
              file=sys.stderr)
    sg = gen.StreamingGenerator(
        params, exp.model, n_seqs=1, temperature=temp or None,
        seed=_or(args.seed, gcfg.seed),
        chunks_per_call=args.chunks_per_call or 1,
        # --stream-key pins a per-stream noise key: the sampled stream
        # becomes a pure function of (key, position) — reproducible
        # across chunk sizes and lookahead schedules, and identical to a
        # StreamPool lane started with the same key
        stream_keys=(int_key(args.stream_key)
                     if args.stream_key is not None else None),
        device=dev)
    if cond is not None:
        sg.set_cond(cond)
    speakers = _speaker_arg(args.speaker, exp, 1)
    # warm up on a throwaway chunk, then RESET so the served audio starts
    # at the true beginning (and the seed continuation starts at the
    # seed's first continuation sample, not one chunk past it)
    sg.emit(chunk, speakers=speakers).cpu()
    sg.reset()
    if args.seed_wav:
        seed_lv, pc = _load_seed_wav(
            args.seed_wav, exp, sr, joint_encoder, args.pase_ckpt, dev,
            warn_tag="--seed-wav", warn_if_unembeddable=cond is not None)
        sg.prime(seed_lv[None], cond=None if pc is None else pc[None],
                 speakers=speakers)
        print(f"[stream] primed on {len(seed_lv)} samples from "
              f"{args.seed_wav}", file=sys.stderr)
    chunks, times = [], []
    if args.blocked:
        # reference loop: materialize each chunk inside the timed region
        # (per-chunk latency bears the full dispatch+transfer round-trip)
        for _ in range(n_chunks):
            t0 = time.perf_counter()
            chunks.append(sg.emit(chunk, speakers=speakers).cpu().numpy())
            times.append(time.perf_counter() - t0)
    else:
        # enqueue-ahead serving loop (default): enqueue chunk i, THEN read
        # chunk i-1 — the device computes chunk i while the host drains
        # i-1.  Each chunk's copy to pinned memory is queued behind its
        # own launch with an event (serve.host_copy), so reading i-1 waits
        # for that copy alone, not for chunk i.  The same emit calls as
        # the blocked loop, so the same samples.
        prev = None
        for _ in range(n_chunks):
            t0 = time.perf_counter()
            cur = host_copy(sg.emit(chunk, speakers=speakers))
            if prev is not None:
                chunks.append(host_wait(prev))
            prev = cur
            times.append(time.perf_counter() - t0)
        chunks.append(host_wait(prev))
    levels = np.concatenate(chunks, axis=1)[0]
    n_out = _write_levels(args.out, levels, exp.model, sr, dev)
    ms = np.asarray(times) * 1e3
    # steady state excludes the first call (no overlapped read yet in
    # enqueue-ahead mode; allocator and cache warmth otherwise)
    steady = ms[1:] if len(ms) > 1 else ms
    chunk_ms = chunk / sr * 1e3
    mode = "blocked" if args.blocked else "enqueue-ahead"
    print(f"[stream] {mode}: {n_chunks} x {chunk}-sample chunks "
          f"({chunk_ms:.0f} ms audio each): median {np.median(steady):.1f}"
          f" ms/chunk, worst {steady.max():.1f} ms -> "
          f"{chunk_ms / np.median(steady):.2f}x realtime; wrote "
          f"{n_out / sr:.2f}s to {args.out}", file=sys.stderr)


def cmd_serve(args):
    """Continuous-batching batch synthesis (serve.run_jobs): drain a
    manifest of variable-length TTS jobs through a StreamPool — each job
    runs for its OWN length and frees its lane to the next job at a chunk
    boundary, so short utterances never wait for long ones the way a
    fixed `generate` batch makes them.  Writes one wav per job as it
    completes plus a stats JSON."""
    import json

    from samplernn_pase_tpu_torch import config as C
    from samplernn_pase_tpu_torch import serve
    from samplernn_pase_tpu_torch.ops.kernels.noise import int_key

    dev = args.device
    exp, restored = _restore(args)
    params, joint_encoder = _split_restored(restored, dev)
    gcfg = exp.generate
    sr = gcfg.sample_rate
    chunk = _chunk_samples(args, exp)

    entries = []
    base = Path(".")
    if args.jobs:
        base = Path(args.jobs).parent
        entries = json.loads(Path(args.jobs).read_text())
        if not isinstance(entries, list):
            sys.exit("--jobs: manifest must be a JSON list of job objects")
    elif args.jobs_dir:
        if not exp.model.cond_dim:
            sys.exit("--jobs-dir synthesizes one job per embedding .npy; "
                     "this checkpoint has no cond_dim — use --n/--length")
        paths = sorted(Path(args.jobs_dir).rglob("*.npy"))
        if not paths:
            sys.exit(f"--jobs-dir: no .npy embeddings under {args.jobs_dir}")
        entries = [{"id": p.stem, "cond": str(p),
                    **({"speaker": args.speaker}
                       if args.speaker is not None else {})}
                   for p in paths]
    elif args.n:
        entries = [{"id": f"job_{i:03d}",
                    "length": args.length or gcfg.length,
                    **({"speaker": args.speaker}
                       if args.speaker is not None else {})}
                   for i in range(args.n)]
    else:
        sys.exit("serve needs a job source: --jobs MANIFEST.json, "
                 "--jobs-dir DIR, or --n N")

    def _path(v):
        q = Path(v)
        return q if q.is_absolute() else base / q

    jobs = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            sys.exit(f"--jobs: entry {i} is not an object: {e!r}")
        jid = e.get("id", i)
        # ids become result filenames: restrict to str/int and reject
        # path-escaping strings (an id of "../x" must not write outside
        # --out)
        if isinstance(jid, bool) or not isinstance(jid, (str, int)):
            sys.exit(f"--jobs: entry {i}: id must be a string or "
                     f"integer, got {jid!r}")
        if isinstance(jid, str) and (
                not jid or "/" in jid or "\\" in jid or ".." in jid):
            sys.exit(f"--jobs: entry {i}: id {jid!r} is empty or "
                     "contains path separators")
        job = {"id": jid}
        cond = None
        if e.get("cond") is not None:
            cond = np.load(_path(e["cond"]))
        elif e.get("cond_wav") is not None:
            cond = _embed_wav(_path(e["cond_wav"]),
                              exp.pase or C.PASEConfig(), joint_encoder,
                              args.pase_ckpt, dev)
        if cond is not None:
            if not exp.model.cond_dim:
                sys.exit(f"job {job['id']!r} has conditioning but the "
                         "model was trained without cond_dim")
            if cond.ndim != 2 or cond.shape[1] != exp.model.cond_dim:
                sys.exit(f"job {job['id']!r}: expected [frames, "
                         f"{exp.model.cond_dim}] embedding, got "
                         f"{cond.shape}")
            job["cond"] = cond
        elif exp.model.cond_dim:
            # fail BEFORE the pool is built, not as a traceback out of
            # pool.start() mid-batch
            sys.exit(f"job {job['id']!r}: this checkpoint was trained "
                     "with conditioning (cond_dim set) — every job "
                     "needs cond/cond_wav (or use --jobs-dir)")
        if e.get("length") is not None:
            job["n_samples"] = int(e["length"])
        elif e.get("seconds") is not None:
            # round, don't truncate: 1.001*16000 is 16015.999... in
            # float64 and int() would lose the last sample
            job["n_samples"] = round(float(e["seconds"]) * sr)
        elif cond is None:
            job["n_samples"] = gcfg.length
        if e.get("speaker") is not None:
            job["speaker"] = int(e["speaker"])
        if exp.model.n_speakers:
            spk = job.get("speaker", args.speaker)
            if spk is None:
                sys.exit(f"job {job['id']!r}: this checkpoint was "
                         "trained with n_speakers — every job needs a "
                         "speaker (or pass --speaker as the default)")
            if not 0 <= int(spk) < exp.model.n_speakers:
                sys.exit(f"job {job['id']!r}: speaker {spk} out of "
                         f"range [0, {exp.model.n_speakers})")
            job["speaker"] = int(spk)
        elif job.get("speaker") is not None:
            sys.exit(f"job {job['id']!r} has a speaker but the model "
                     "was trained without n_speakers")
        if e.get("seed_wav") is not None:
            job["seed_levels"], sc = _load_seed_wav(
                _path(e["seed_wav"]), exp, sr, joint_encoder,
                args.pase_ckpt, dev, warn_tag=f"job {job['id']!r} seed_wav")
            if sc is not None:
                job["seed_cond"] = sc
        if e.get("stream_key") is not None:
            sk = e["stream_key"]
            if isinstance(sk, (list, tuple)):
                # the raw [2] uint32 words (what StreamPool.start takes
                # and what the reference's key_data prints) — pass through
                if len(sk) != 2:
                    sys.exit(f"job {job['id']!r}: stream_key list must "
                             f"be the raw [2]-uint32 key data, got "
                             f"{len(sk)} entries")
                job["stream_key"] = np.asarray(sk, np.uint32)
            elif isinstance(sk, (int, float)) and not isinstance(sk, bool) \
                    and float(sk).is_integer():
                job["stream_key"] = int_key(int(sk))
            else:
                sys.exit(f"job {job['id']!r}: stream_key must be an int "
                         f"seed or a [2]-uint32 raw key, got {sk!r}")
        jobs.append(job)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def _fname(jid):
        return f"{jid}.wav" if isinstance(jid, str) else f"job_{jid:03d}.wav"

    written = []

    def on_done(jid, levels):
        _write_levels(out / _fname(jid), levels, exp.model, sr, dev)
        written.append(jid)

    temp = _or(args.temperature, gcfg.temperature)
    if not temp:
        keyed = [j["id"] for j in jobs if "stream_key" in j]
        if keyed:
            sys.exit(f"--temperature 0 (greedy) but jobs {keyed} pin a "
                     "stream_key — greedy synthesis has no sampling "
                     "noise to pin")
    # every wav streams out through on_done — retaining the whole batch's
    # audio in run_jobs' results would scale host memory with the
    # manifest instead of with in-flight work
    _, stats = serve.run_jobs(
        params, exp.model, jobs, n_lanes=args.lanes, chunk=chunk,
        temperature=temp or None,
        seed=_or(args.seed, gcfg.seed),
        on_done=on_done, retain_results=False, device=dev)
    stats["sample_rate"] = sr
    stats["realtime_x"] = round(
        stats["generated"] / max(stats["wall_s"], 1e-9) / sr, 2)
    (out / "serve_stats.json").write_text(json.dumps(stats, indent=1))
    print(f"[serve] {stats['jobs']} jobs over {stats['lanes']} lanes in "
          f"{stats['chunks']} chunks ({stats['wall_s']:.2f}s, "
          f"{stats['realtime_x']}x realtime aggregate, utilization "
          f"{stats['utilization']:.2f}); wrote {len(written)} wavs to "
          f"{out}", file=sys.stderr)
    print(json.dumps(stats))


def _pick_step(args, mgr):
    """--step N > --best (lowest recorded val NLL) > latest."""
    if getattr(args, "step", None) is not None:
        return args.step
    if getattr(args, "best", False):
        step = mgr.best_step(strict=True)
        if step is None:
            print("[warn] --best: no checkpoint has a recorded val NLL "
                  "(no held-out split?); using the latest step instead",
                  file=sys.stderr)
        return step      # None -> restore() uses the latest step
    return None          # restore() defaults to the latest step


def cmd_evaluate(args):
    """Held-out NLL (bits/sample) of a checkpoint over a corpus split."""
    import json

    import torch

    from samplernn_pase_tpu_torch.data.dataset import (
        WavCorpus, device_put_batch)
    from samplernn_pase_tpu_torch.models import samplernn
    from samplernn_pase_tpu_torch.train.joint import joint_cond
    from samplernn_pase_tpu_torch.train.trainer import make_eval_step

    dev = args.device
    exp, restored = _restore(args)
    params, joint_encoder = _split_restored(restored, dev)
    tcfg = exp.train
    batch_size = args.batch_size or tcfg.batch_size
    seq_len = args.seq_len or tcfg.seq_len
    corpus = WavCorpus.from_folder(
        args.dataset, exp.model.q_levels, cond_dir=args.cond_dir or None,
        codec=exp.model.codec, sample_rate=tcfg.sample_rate)
    held_out = bool({"val": corpus.val_idx,
                     "test": corpus.test_idx}.get(args.split))
    split_idx = ({"train": corpus.train_idx, "val": corpus.val_idx,
                  "test": corpus.test_idx}[args.split]
                 or corpus.train_idx)
    # splits smaller than batch_size would recycle utterances into lanes
    # (dataset.batcher) and double-count them; one lane scores everything
    # exactly once (reset flags at utterance starts).  Larger splits run
    # at full batch — per-lane tail passes below keep that exact too
    if len(split_idx) < batch_size:
        batch_size = 1
    # what conditioning the eval actually uses — a cond_dim model
    # evaluated with NONE (forgotten --cond-dir) reports a misleading
    # NLL, so tag it and warn
    if not exp.model.cond_dim:
        conditioning = "none"
    elif corpus.conditioning is not None:
        conditioning = "cached"
    elif joint_encoder is not None:
        conditioning = "joint"
    elif exp.model.n_speakers:
        conditioning = "speaker-only"
    else:
        conditioning = "MISSING"
        print("[warn] model was trained with conditioning "
              "(cond_dim set) but no source is available — pass "
              "--cond-dir; this NLL is for UNCONDITIONED inputs",
              file=sys.stderr)
    step = make_eval_step(exp.model)
    hiddens = samplernn.initial_state(params, exp.model, batch_size)
    use_joint = joint_encoder is not None and exp.model.cond_dim
    # per-batch masked means weighted by each batch's REAL sample count
    # (tail padding excluded); the NLLs stay on the device and are read
    # in one copy at the end (no host sync per batch)
    nlls, weights = [], []

    def score(item, hid):
        if isinstance(item, tuple) and len(item) == 2:
            chunk, cond = item     # (Chunk, cond) pair — conditioned corpus
        else:
            chunk, cond = item, None
        x, y, r = device_put_batch(
            (chunk.inputs, chunk.targets, chunk.resets.astype(np.float32)),
            dev)
        kwargs = {}
        if cond is not None:
            kwargs["cond"] = device_put_batch(cond, dev)
        elif use_joint:
            # --joint checkpoint: conditioning comes from the adapted
            # encoder (eval mode) over the batch waveform, as in training
            kwargs["cond"] = joint_cond(*joint_encoder, exp.model, exp.pase,
                                        x, train=False)[0]
        if exp.model.n_speakers and chunk.speakers is not None:
            kwargs["speakers"] = device_put_batch(chunk.speakers, dev)
        if chunk.valid is not None and np.any(
                chunk.valid < chunk.targets.shape[-1]):
            kwargs["valid"] = device_put_batch(chunk.valid, dev)
        hid, nll = step(params, hid, x, y, r, **kwargs)
        nlls.append(nll)
        weights.append(float(np.sum(chunk.valid))
                       if chunk.valid is not None
                       else float(np.size(chunk.targets)))
        return hid

    batcher = corpus.batcher(args.split, batch_size, seq_len,
                             exp.model.lookback,
                             cond_rate=exp.model.cond_rate or None)
    with torch.inference_mode():
        for item in batcher:
            hiddens = score(item, hiddens)
        # exact coverage at ANY batch size: the aligned epoch stops at the
        # shortest lane, so longer lanes may hold unconsumed tail chunks.
        # Score each lane's tail with a 1-wide pass that CONTINUES from
        # that lane's carried hidden state, so full-batch evaluate equals
        # the 1-lane exact NLL
        if batch_size > 1:
            for b in range(batch_size):
                tail = batcher.lane_tail(b)
                first = next(tail, None)
                if first is None:
                    continue
                h1 = samplernn.slice_state_lane(hiddens, b)
                h1 = score(first, h1)
                for item in tail:
                    h1 = score(item, h1)
        vals = (torch.stack([v.reshape(()) for v in nlls]).double().cpu()
                .numpy() if nlls else np.zeros(0))
    n_batches = len(nlls)
    w = np.asarray(weights)
    mean = float(np.sum(vals * w) / max(np.sum(w), 1.0)) if n_batches \
        else 0.0
    # coverage: scored samples / the split's real samples.  Exactly 1.0
    # by construction — the aligned pass plus the per-lane tail passes
    # score every real sample once (padding masked, nothing recycled)
    total_real = sum(len(corpus.utterances[i]) for i in split_idx)
    coverage = float(np.sum(w)) / max(total_real, 1)
    out = {
        "split": args.split,
        "nll_bits": round(mean, 6),
        "batches": n_batches,
        "samples": int(np.sum(w)),
        "coverage": round(coverage, 4),
        "held_out": held_out,   # False = split was empty, train fallback
        "utterances": len(split_idx),
        "batch_size": batch_size,
        "step": int(restored["step"]),
    }
    if exp.model.cond_dim:
        out["conditioning"] = conditioning
    print(json.dumps(out))


def _resolve_platform(platform: str):
    """The device every verb runs on, resolved once before any verb runs.

    ``cpu`` is the CPU.  ``auto`` and ``cuda`` need a CUDA device: CUDA is
    brought up in a watchdog thread bounded by ``SRNN_INIT_TIMEOUT_S``
    (default 180 s), so a driver that hangs fails loudly (the hung thread
    holds CUDA's init lock, so the process exits), and a host without a
    card exits with a message naming ``--platform cpu``.  Nothing falls
    back to the CPU."""
    import os
    import threading

    import torch

    from samplernn_pase_tpu_torch.device import resolve_device

    if platform == "cpu":
        return resolve_device("cpu")
    why = ["CUDA init raised an error"]

    def init():
        if not torch.cuda.is_available():
            why[0] = "torch.cuda.is_available() is false"
            return
        torch.cuda.init()
        why[0] = None

    timeout = os.environ.get("SRNN_INIT_TIMEOUT_S", "180")
    t = threading.Thread(target=init, daemon=True)
    t.start()
    t.join(timeout=float(timeout))
    if t.is_alive():
        print(f"error: CUDA init did not complete within {timeout}s — the "
              "driver or the card is not answering. Rerun with --platform "
              "cpu, or raise SRNN_INIT_TIMEOUT_S.", file=sys.stderr,
              flush=True)
        os._exit(2)          # the hung thread holds CUDA's init lock
    if why[0] is not None:
        sys.exit(f"error: --platform {platform} needs a CUDA device and "
                 f"found none ({why[0]}); rerun with --platform cpu to run "
                 "on the CPU")
    return resolve_device("cuda")


def main(argv=None):
    p = argparse.ArgumentParser(prog="samplernn_pase_tpu_torch")
    p.add_argument("--platform", choices=["auto", "cuda", "cpu"],
                   default="auto",
                   help="device selection: cpu runs every verb on the "
                        "CPU; cuda requires a CUDA device; auto means "
                        "cuda (CUDA init is bounded by a watchdog so a "
                        "hung driver fails loudly instead of hanging)")
    sub = p.add_subparsers(dest="verb", required=True)

    pt = sub.add_parser("train")
    _add_model_flags(pt)
    pt.add_argument("--config")
    pt.add_argument("--preset")
    pt.add_argument("--dataset")
    pt.add_argument("--cond-dir", dest="cond_dir")
    pt.add_argument("--exp-dir", dest="exp_dir")
    pt.add_argument("--batch_size", type=int)
    pt.add_argument("--seq_len", type=int)
    pt.add_argument("--lr", type=float)
    pt.add_argument("--lr_schedule",
                    choices=["constant", "cosine", "exponential"])
    pt.add_argument("--epochs", type=int)
    pt.add_argument("--seed", type=int)
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--joint", action="store_true",
                    help="end-to-end PASE+SampleRNN training (config 4)")
    pt.add_argument("--freeze-pase", dest="freeze_pase",
                    action="store_true")
    pt.add_argument("--pase-ckpt", dest="pase_ckpt")
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("extract")
    pe.add_argument("--dataset", required=True)
    pe.add_argument("--out", required=True)
    pe.add_argument("--pase-ckpt", dest="pase_ckpt")
    pe.add_argument("--ckpt",
                    help="`train --joint` experiment dir: use its "
                         "adapted encoder instead of --pase-ckpt")
    pe.add_argument("--batch_size", type=int)
    pe.set_defaults(fn=cmd_extract)

    pg = sub.add_parser("generate")
    pg.add_argument("--ckpt", required=True, help="experiment dir")
    pg.add_argument("--out", required=True)
    pg.add_argument("--n_seqs", type=int)
    pg.add_argument("--length", type=int)
    pg.add_argument("--temperature", type=float)
    pg.add_argument("--seed", type=int)
    pg.add_argument("--cond", help=".npy PASE embedding for TTS")
    pg.add_argument("--cond-wav", dest="cond_wav",
                    help="condition on this wav's PASE embedding "
                         "(uses the joint ckpt's encoder when present, "
                         "else --pase-ckpt)")
    pg.add_argument("--pase-ckpt", dest="pase_ckpt",
                    help="torch PASE ckpt for --cond-wav on non-joint "
                         "experiments")
    pg.add_argument("--speaker", type=int,
                    help="speaker id (models trained with n_speakers)")
    pg.add_argument("--seed-wav", dest="seed_wav",
                    help="wav file to continue from (primes decoder state)")
    pg.add_argument("--best", action="store_true",
                    help="use the best-by-val-NLL checkpoint, not latest")
    pg.add_argument("--step", type=int,
                    help="use this exact checkpoint step")
    pg.set_defaults(fn=cmd_generate)

    ps = sub.add_parser("stream",
                        help="chunked streaming synthesis (serving path)")
    ps.add_argument("--ckpt", required=True, help="experiment dir")
    ps.add_argument("--out", required=True, help="output wav path")
    ps.add_argument("--seconds", type=float, default=None)
    ps.add_argument("--chunk-ms", dest="chunk_ms", type=float,
                    default=None, help="audio per chunk (default 64 ms)")
    ps.add_argument("--chunks-per-call", dest="chunks_per_call",
                    type=int, default=None,
                    help="lookahead chunks per device call")
    ps.add_argument("--temperature", type=float)
    ps.add_argument("--seed", type=int)
    ps.add_argument("--stream-key", dest="stream_key", type=int,
                    help="per-stream noise key: sampled output becomes "
                         "a pure function of (key, position) — "
                         "invariant to --chunk-ms and "
                         "--chunks-per-call, reproducible by a "
                         "StreamPool lane with the same key")
    ps.add_argument("--speaker", type=int)
    ps.add_argument("--cond", help=".npy PASE embedding stream for TTS")
    ps.add_argument("--cond-wav", dest="cond_wav",
                    help="condition the stream on this wav's PASE "
                         "embedding (joint ckpt encoder or --pase-ckpt)")
    ps.add_argument("--pase-ckpt", dest="pase_ckpt",
                    help="torch PASE ckpt for --cond-wav on non-joint "
                         "experiments")
    ps.add_argument("--seed-wav", dest="seed_wav",
                    help="wav to continue from (primes decoder state)")
    ps.add_argument("--blocked", action="store_true",
                    help="materialize each chunk before emitting the "
                         "next (default: enqueue-ahead pipelining)")
    ps.add_argument("--best", action="store_true")
    ps.add_argument("--step", type=int)
    ps.set_defaults(fn=cmd_stream)

    pj = sub.add_parser(
        "serve",
        help="continuous-batching batch synthesis: drain a manifest of "
             "variable-length jobs through a StreamPool")
    pj.add_argument("--ckpt", required=True, help="experiment dir")
    pj.add_argument("--out", required=True, help="output directory")
    pj.add_argument("--jobs",
                    help="JSON manifest: a list of objects with optional "
                         "id, length (samples) / seconds, cond (.npy), "
                         "cond_wav, speaker, seed_wav, stream_key (int); "
                         "relative paths resolve against the manifest")
    pj.add_argument("--jobs-dir", dest="jobs_dir",
                    help="one conditioned job per *.npy embedding under "
                         "this directory (length = the utterance's own "
                         "cond duration)")
    pj.add_argument("--n", type=int,
                    help="N unconditioned jobs of --length samples")
    pj.add_argument("--length", type=int,
                    help="samples per job for --n (default: config)")
    pj.add_argument("--lanes", type=int, default=8,
                    help="pool lanes (resident batch size; default 8)")
    pj.add_argument("--chunk-ms", dest="chunk_ms", type=float,
                    default=None, help="audio per dispatch (default 64 ms)")
    pj.add_argument("--temperature", type=float)
    pj.add_argument("--seed", type=int)
    pj.add_argument("--speaker", type=int,
                    help="speaker id applied to --n/--jobs-dir jobs")
    pj.add_argument("--pase-ckpt", dest="pase_ckpt",
                    help="torch PASE ckpt for cond_wav/seed_wav entries "
                         "on non-joint experiments")
    pj.add_argument("--best", action="store_true")
    pj.add_argument("--step", type=int)
    pj.set_defaults(fn=cmd_serve)

    pv = sub.add_parser("evaluate",
                        help="held-out NLL (bits/sample) of a checkpoint")
    pv.add_argument("--ckpt", required=True, help="experiment dir")
    pv.add_argument("--dataset", required=True)
    pv.add_argument("--split", choices=["val", "test", "train"],
                    default="test")
    pv.add_argument("--cond-dir", dest="cond_dir")
    pv.add_argument("--batch_size", type=int)
    pv.add_argument("--seq_len", type=int)
    pv.add_argument("--best", action="store_true",
                    help="use the best-by-val-NLL checkpoint, not latest")
    pv.add_argument("--step", type=int,
                    help="use this exact checkpoint step")
    pv.set_defaults(fn=cmd_evaluate)

    args = p.parse_args(argv)
    args.device = _resolve_platform(args.platform)
    # float32 products at full precision for the whole process: no TF32
    # in matmuls or cuDNN convolutions, float32 reductions in 16-bit
    # matmuls
    from samplernn_pase_tpu_torch.ops.kernels.decode import plain_numerics
    plain_numerics()
    args.fn(args)


if __name__ == "__main__":
    main()

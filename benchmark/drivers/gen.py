"""Offline batch synthesis: a closed loop of requests through the port's
generation entry on the kernel route.

Each request generates ``samples`` levels on each of ``lanes`` lanes at
``temperature`` (``generate.generate_levels`` with the weights prepared
once, ``generate.prepare_weights``) and decodes them to a waveform (K7,
``generate.decode_waveform``), which is copied to the host: that is
``generate.generate`` with the preparation hoisted out of the request.  A
request counts once its waveform is on the host.  Requests run back to
back until the window has lasted ``--seconds``; the window ends with the
last request it started.

Checked: ``check_requests`` requests (the first, the last and ones drawn
from the seed), ``check_lanes`` lanes of each; the levels their waveform
encodes are replayed through the reference with each lane's noise
(``token_gap``), and each sample's distance from its level's mu-law value
(``wave_err``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generator, harness
from benchmark.reference import check as rcheck
from benchmark.weights import make_params


def setup(run):
    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

    tr = run.traffic
    b, n = tr["lanes"], tr["samples"]
    params = make_params(run.model, run.seed, run.device)
    weights = gen.prepare_weights(params, run.cfg, run.device)
    rng = generator.rng_for(run.seed, 1)
    # one warm request of two top frames and the waveform at full size:
    # every kernel and plan the window uses is built here
    warm = gen.generate_levels(params, run.cfg, b, 2 * run.cfg.lookback,
                               tr["temperature"], seed=1, device=run.device,
                               kernel_weights=weights)
    gen.decode_waveform(torch.zeros((b, n), dtype=torch.int32,
                                    device=run.device), run.cfg).cpu()
    del warm
    kdec.reset_launches()
    return {"params": params, "weights": weights, "rng": rng,
            "check_lanes": np.sort(rng.choice(b, tr["check_lanes"],
                                              replace=False))}


def window(run, state):
    from samplernn_pase_tpu_torch import generate as gen
    from samplernn_pase_tpu_torch.ops.kernels import decode as kdec

    tr = run.traffic
    b, n = tr["lanes"], tr["samples"]
    lanes = state["check_lanes"]
    seeds, kept = [], []
    run.start_window()
    kdec.reset_launches()
    while True:
        run.tick()
        seed = int(state["rng"].integers(0, 2 ** 62))
        with run.span("request"):
            with run.span("generate"):
                levels = gen.generate_levels(
                    state["params"], run.cfg, b, n, tr["temperature"],
                    seed=seed, device=run.device,
                    kernel_weights=state["weights"])
            with run.span("waveform"):
                wave = gen.decode_waveform(levels, run.cfg)
            with run.span("to_host"):
                host = wave.cpu()
        seeds.append(seed)
        kept.append(host[lanes].clone())
        del levels, wave, host
        if run.elapsed() >= run.seconds:
            break
    run.end_window()
    run.attempted = len(seeds)
    samples = len(seeds) * b * n
    run.e2e["gen_samples_per_s"] = samples / run.window_s
    run.counters.update(
        samples=samples, requests=len(seeds),
        top_frames=len(seeds) * (-(-n // run.cfg.lookback)),
        launches=sum(kdec.LAUNCHES[k] for k in (
            "frame_decode", "gemm_bias", "gru_gates", "lstm_gates")),
        lanes=b)
    state.update(seeds=seeds, kept=kept)


def check(run, state):
    tr = run.traffic
    state["weights"] = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    r = len(state["seeds"])
    pick = {0, r - 1}
    extra = [i for i in range(1, r - 1)]
    rng = generator.rng_for(run.seed, 2)
    while len(pick) < min(r, tr["check_requests"]) and extra:
        pick.add(extra.pop(int(rng.integers(len(extra)))))
    pick = sorted(pick)
    lanes = state["check_lanes"]
    waves = torch.cat([state["kept"][i] for i in pick]).to(run.device)
    levels, wave_err = rcheck.waveform_error(waves, run.cfg.q_levels)
    seeds = np.repeat([state["seeds"][i] for i in pick], len(lanes))
    lane_idx = np.tile(lanes, len(pick))
    out = rcheck.token_gaps(
        state["params"], run.model, levels,
        [levels.shape[1]] * levels.shape[0],
        ("seed", seeds, lane_idx), tr["temperature"],
        control=run.control)
    program = {"token_gap": out["gap"], "wave_err": wave_err}
    run.readings = dict(program, tokens=out["tokens"])
    control = None
    if "control_gap" in out:
        control = {"token_gap": out["control_gap"],
                   "wave_err": rcheck.control_waveform_error(
                       levels, run.cfg.q_levels)}
        run.readings.update({f"control_{k}": v for k, v in control.items()})
    return harness.compared(run, program, control)

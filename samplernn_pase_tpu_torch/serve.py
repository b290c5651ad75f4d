"""Multi-stream serving: a fixed-lane pool with per-lane lifecycle, the
counterpart of ``samplernn_pase_tpu.serve.StreamPool``.

``StreamPool`` is the serving layer above
:class:`~samplernn_pase_tpu_torch.generate.StreamingGenerator`: one batch
of ``n_lanes`` decode lanes advancing in lock-step, one
``generate_levels`` call per chunk for all lanes, where TTS streams join
and leave at chunk boundaries without stopping the batch (continuous
batching with static shapes and recycled slots).

Every lane is independent in the model and in the kernels (K1 and K2 give
a row the same bits at any batch size), so a pool lane's stream equals a
solo B=1 generator's given the same conditioning and, sampled, the same
noise key: one user's audio does not depend on who else is served.  A
slot that serves no request still computes, as static-shape batching
does.

Per-lane conditioning lives on the device: each lane's stream is copied
once at ``start()`` into ``[n_lanes, cap, cond_dim]`` float32, padded by
repeating its last row (the clamp-past-end semantics) with the speaker
embedding folded in, and every emit passes the whole buffer with the
per-lane sample cursors; the kernel route gathers each lane's rows at its
own offset and K2 resolves its sub-row phase, so chunks need only be
multiples of ``lookback``.

Per-lane noise: a lane's key is set at ``start()``, pinned by the caller
(``stream_key``, [2] uint32 words) or derived by ``noise.lane_key(seed,
lane, epoch)``, where epoch counts that lane's claims; its noise at local
position p depends on the key and p only.

The lifecycle updates build new state, window and counter tensors rather
than writing in place (the window an emit carries is a view of the levels
it returned, which the caller still holds); the conditioning buffer, which
no output views, is updated in place to save a copy of it per join.
A join's host arrays (conditioning rows, stream key) reach the card
through pinned memory without blocking the host, so a join does not wait
for the chunks already queued (a join with a prompt does: ``prime`` copies
its levels and rows and runs the model on them).

``run_jobs`` drains a manifest of variable-length jobs through one pool
(continuous batching), enqueue-ahead: chunk t+1 is launched before chunk
t is read, and each chunk is copied into pinned host memory behind its
own launch, so reading it waits for that copy only.

Under a mesh (``parallel.mesh``, one process per rank) the lanes split
over its ``data`` axis: rank r holds lanes [r n/dp, (r+1) n/dp), their
states, windows, cursors, lane keys, noise positions and conditioning
rows.  Every rank makes the same lifecycle calls and keeps the same free
list, so a start returns the same lane everywhere; the owning rank alone
does a join's, a prompt's or an extension's device work.  A lane's noise
key is derived from its global index.  ``emit`` runs ``generate_levels``
on the rank's block and gathers the whole [n_lanes, n] on every rank.
The kernels fuse the whole MLP and its Gumbel-max, so a ``model`` axis
> 1 does not split it here: the pool gathers MLP shards whole at
construction and the ranks along ``model`` repeat the same lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from samplernn_pase_tpu_torch import generate as gen
from samplernn_pase_tpu_torch.config import SampleRNNConfig
from samplernn_pase_tpu_torch.data.dataset import device_put_batch
from samplernn_pase_tpu_torch.device import resolve_device
from samplernn_pase_tpu_torch.models import samplernn
from samplernn_pase_tpu_torch.ops.kernels.noise import lane_key
from samplernn_pase_tpu_torch.ops.mulaw import quantize_zero
from samplernn_pase_tpu_torch.parallel import mesh as pm
from samplernn_pase_tpu_torch.tree import tree_map


def _pool_join(params, cfg, states, hist, lane: int, lane_keys, noise_pos,
               stream_key, cursors, cond_buf, cond_dev, spk):
    """The pool tensors after lane ``lane`` joins: fresh state (learned h0)
    and q_zero window; with ``stream_key`` ([2] int64 words) its noise key
    and position 0; with ``cond_dev`` ([cap, D], already padded) its
    conditioning, the speaker row ``spk`` folded in, and cursor 0.  Returns
    (states, hist, lane_keys, noise_pos, cursors, cond_buf): new tensors,
    but for ``cond_buf``, written in place."""
    b = hist.shape[0]
    resets = (torch.arange(b, device=hist.device) == lane).to(torch.float32)
    states = samplernn.reset_state(params, cfg, states, resets)
    hist = hist.clone()
    hist[lane] = quantize_zero(cfg.q_levels)
    if stream_key is not None:
        lane_keys = lane_keys.clone()
        lane_keys[lane] = stream_key
        noise_pos = noise_pos.clone()
        # fill_, not ``[lane] = 0``: assigning a number to one element
        # copies it from the host and waits for the card
        noise_pos[lane].fill_(0)
    if cond_dev is not None:
        if spk is not None:
            # folded once; the solo generator adds it per emit, and the
            # sum is the same either way
            cond_dev = cond_dev + params["speaker"][spk]
        cond_buf[lane] = cond_dev              # in place, see above
        cursors = cursors.clone()
        cursors[lane].fill_(0)
    return states, hist, lane_keys, noise_pos, cursors, cond_buf


def _advance(cursors, noise_pos, n: int):
    """Both per-lane counters after an emit of ``n`` samples."""
    return cursors + n, noise_pos + n


def _pool_extend(params, cond_buf, lane: int, ln: int, rows_dev, spk):
    """``extend_cond``'s lane rewrite, in place: ``rows_dev`` ([kb, D],
    last-row padded to its bucket; the speaker row ``spk`` folded in)
    lands at row ``ln`` of the lane and the tail past it re-clamps to the
    new last row."""
    if spk is not None:
        rows_dev = rows_dev + params["speaker"][spk]
    kb = rows_dev.shape[0]
    posi = torch.arange(cond_buf.shape[1], device=cond_buf.device)
    gathered = rows_dev[(posi - ln).clamp(0, kb - 1)]
    cond_buf[lane] = torch.where((posi >= ln)[:, None], gathered,
                                 cond_buf[lane])
    return cond_buf


def _scatter_lane(pool_states, one_states, lane: int):
    """Write a batch-1 state (per tier [n_rnn, (2,) 1, H]) into lane
    ``lane`` of the pool's state (batch axis -2)."""
    out = []
    for p, o in zip(pool_states, one_states):
        p = p.clone()
        p[..., lane, :] = o[..., 0, :].to(p.dtype)
        out.append(p)
    return tuple(out)


class StreamPool:
    """``n_lanes`` independent audio streams, one generation call per chunk.

    >>> pool = StreamPool(params, cfg, n_lanes=8, temperature=0.95)
    >>> a = pool.start(cond=emb_a, speaker=3)       # claims a free lane
    >>> chunk = pool.emit(1280)                     # [8, 1280] int32
    >>> audio_a = chunk[a]                          # lane a's samples
    >>> pool.stop(a)                                # slot reusable

    ``emit`` returns the whole batch; the serving layer reads the lanes it
    owns.  A sampled lane's stream is a pure function of its start (its
    key, its conditioning, its prompt): it does not change when other
    streams join or leave, and equals a solo
    ``StreamingGenerator(n_seqs=1, stream_keys=key)`` with the same key.
    Runs on ``device`` (default CUDA) through ``use_kernels``' route; the
    kernel route prepares its weights once.  ``mesh``: lanes split over
    its ``data`` axis (see the module docstring); ``states``, ``hist``
    and the other lane arrays then hold this rank's block.
    """

    def __init__(self, params, cfg: SampleRNNConfig, n_lanes: int,
                 temperature: float | None = 1.0, seed: int = 0,
                 use_kernels: bool | str | None = None,
                 max_cond_frames: int = 1024, device=None, mesh=None):
        if n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        dp = pm.axis_size(mesh, "data")
        if n_lanes % dp:
            raise ValueError(f"n_lanes={n_lanes} must divide over the mesh "
                             f"data axis ({dp})")
        self.mesh = mesh
        self.n_local = int(n_lanes) // dp          # this rank's lanes
        self._lo = pm.axis_rank(mesh, "data") * self.n_local
        if pm.axis_size(mesh, "model") > 1 and pm.mlp_is_sharded(
                params["mlp"]):
            params = pm.unshard_params(params, mesh)
        dev = self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(dev), params)
        self.cfg, self.n = cfg, int(n_lanes)
        self.temperature = temperature
        self.seed = int(seed)
        self.use_kernels = use_kernels
        self._weights = gen.KernelWeights(cfg, dev, use_kernels)
        i64 = dict(dtype=torch.int64, device=dev)
        nl = self.n_local
        self._lane_keys = torch.zeros((nl, 2), **i64)
        self._noise_pos = torch.zeros((nl,), **i64)
        self._epochs = [0] * self.n         # claims of each lane so far
        self.states = samplernn.initial_state(self.params, cfg, nl)
        self.hist = torch.full((nl, cfg.lookback),
                               quantize_zero(cfg.q_levels), dtype=torch.int32,
                               device=dev)
        self._free = list(range(self.n - 1, -1, -1))   # pop() -> lane 0 first
        self.active: set[int] = set()
        # device memory: n_lanes x cap x cond_dim x 4 bytes
        self._f_cap = int(max_cond_frames)
        self._cond_buf = (torch.zeros((nl, self._f_cap, cfg.cond_dim),
                                      device=dev)
                          if cfg.cond_dim else None)
        self._cond_len = [0] * self.n       # unpadded rows per lane
        self._cursors = torch.zeros((nl,), **i64)        # in samples
        self._speakers = (np.zeros((self.n,), np.int64)
                          if cfg.n_speakers else None)

    def _local(self, lane: int):
        """Lane ``lane``'s index in this rank's block, or None when
        another rank holds it."""
        i = lane - self._lo
        return i if 0 <= i < self.n_local else None

    # -- lifecycle -------------------------------------------------------
    def start(self, cond=None, speaker=None, seed_levels=None,
              seed_cond=None, lane: int | None = None,
              stream_key=None) -> int:
        """Claim a lane for a new stream and return its index.

        cond: [frames, cond_dim] conditioning stream (required iff the model
        has cond_dim).  speaker: int id (required iff the model has
        n_speakers).  seed_levels: optional [L] or [1, L] int prompt that
        the lane continues (``generate.prime``, with ``seed_cond`` rows
        covering the seed).  stream_key: optional [2] uint32 words pinning
        this stream's sampling noise (default ``noise.lane_key(seed, lane,
        epoch)``).  Everything is validated before the lane is claimed: a
        rejected start does not leak the slot."""
        if lane is None:
            if not self._free:
                raise RuntimeError(
                    f"pool exhausted: all {self.n} lanes active")
        elif lane in self.active:
            raise ValueError(f"lane {lane} is already active")
        elif lane not in self._free:
            raise ValueError(f"lane {lane} out of range [0, {self.n})")
        if self.cfg.cond_dim:
            if cond is None:
                raise ValueError(
                    "model has cond_dim: start(cond=...) is required")
            cond = _host(cond)
            if cond.ndim != 2 or cond.shape[0] == 0 \
                    or cond.shape[1] != self.cfg.cond_dim:
                raise ValueError(
                    f"cond must be [frames, {self.cfg.cond_dim}], "
                    f"got {cond.shape}")
        elif cond is not None:
            raise ValueError("cond passed to an unconditioned model")
        if self.cfg.n_speakers:
            if speaker is None:
                raise ValueError(
                    "model has n_speakers: start(speaker=...) is required")
            if not 0 <= int(speaker) < self.cfg.n_speakers:
                raise ValueError(f"speaker {speaker} out of range "
                                 f"[0, {self.cfg.n_speakers})")
        if stream_key is not None:
            if self.temperature is None:
                raise ValueError(
                    "stream_key passed to a greedy pool "
                    "(temperature=None): there is no sampling noise "
                    "to pin")
            stream_key = np.asarray(_host(stream_key, None), np.uint32)
            if stream_key.shape != (2,):
                raise ValueError("stream_key must be [2] uint32 words "
                                 f"(noise.lane_key), got {stream_key.shape}")
        seed = sc = None
        if seed_cond is not None and seed_levels is None:
            raise ValueError(
                "seed_cond passed without seed_levels: the rows cover a "
                "prompt, and there is none")
        if seed_levels is not None:
            seed = np.asarray(_host(seed_levels, None)).astype(np.int64)
            if seed.ndim == 1:
                seed = seed[None]
            if seed.ndim != 2 or seed.shape[0] != 1:
                raise ValueError("seed_levels must be one lane: [L] or "
                                 f"[1, L], got {np.shape(seed_levels)}")
            if seed_cond is not None:
                sc = _host(seed_cond)
                if sc.ndim != 2 or sc.shape[1] != self.cfg.cond_dim:
                    raise ValueError(
                        f"seed_cond must be [frames, {self.cfg.cond_dim}]"
                        f", got {sc.shape}")
                sc = sc[None]
        # claim and commit; only prime() below can still raise
        lane = self._free.pop() if lane is None else (
            self._free.remove(lane) or lane)
        words = None
        if self.temperature is not None:
            # the global lane index: a lane samples the same noise on any
            # mesh
            words = (stream_key if stream_key is not None
                     else lane_key(self.seed, lane, self._epochs[lane]))
        self._epochs[lane] += 1
        if self.cfg.cond_dim:
            self._ensure_cap(cond.shape[0])
            self._cond_len[lane] = cond.shape[0]
        spk = None
        if self.cfg.n_speakers:
            self._speakers[lane] = int(speaker)
            spk = int(speaker)
        local = self._local(lane)
        if local is None:                   # another rank's lane
            self.active.add(lane)
            return lane
        skey = (None if words is None
                else device_put_batch(words.astype(np.int64), self.device))
        cond_dev = (device_put_batch(gen.fit_cond_stream(cond, self._f_cap),
                                     self.device)
                    if self.cfg.cond_dim else None)
        (self.states, self.hist, self._lane_keys, self._noise_pos,
         self._cursors, self._cond_buf) = _pool_join(
            self.params, self.cfg, self.states, self.hist, local,
            self._lane_keys, self._noise_pos, skey, self._cursors,
            self._cond_buf, cond_dev, spk)
        if seed is not None:
            spk1 = (np.asarray([self._speakers[lane]])
                    if self._speakers is not None else None)
            try:
                s1, h1 = gen.prime(self.params, self.cfg, seed, cond=sc,
                                   speakers=spk1, device=self.device)
            except Exception:
                # the lane's state was reset above: returning it is safe
                self._free.append(lane)
                raise
            self.states = _scatter_lane(self.states, s1, local)
            hist = self.hist.clone()
            hist[local] = h1[0]
            self.hist = hist
        self.active.add(lane)
        return lane

    def _ensure_cap(self, frames: int):
        """Grow the device conditioning buffer (doubling) to ``frames`` rows
        per lane.  The pad repeats each lane's last row, its clamp row
        already, so no active lane's decode changes."""
        if self._cond_buf is None or frames <= self._f_cap:
            return
        new_cap = max(gen.next_pow2(frames), 2 * self._f_cap)
        pad = self._cond_buf[:, -1:, :].expand(
            self.n_local, new_cap - self._f_cap, self.cfg.cond_dim)
        self._cond_buf = torch.cat([self._cond_buf, pad], dim=1)
        self._f_cap = new_cap

    def extend_cond(self, lane: int, rows):
        """Append conditioning rows to an active lane's stream (a streaming
        TTS encoder producing more rows of the same utterance): ``rows``
        [k, cond_dim] land at the lane's unpadded length and the tail past
        the new end re-clamps to the new last row.  Samples already emitted
        are unaffected; extend before the cursor reaches the rows that
        matter.  Grows the buffer as needed."""
        if not self.cfg.cond_dim:
            raise ValueError("extend_cond on a model without cond_dim")
        if lane not in self.active:
            raise ValueError(f"lane {lane} is not active")
        rows = _host(rows)
        if rows.ndim != 2 or rows.shape[0] == 0 \
                or rows.shape[1] != self.cfg.cond_dim:
            raise ValueError(
                f"rows must be [k>0, {self.cfg.cond_dim}], "
                f"got {rows.shape}")
        ln, k = self._cond_len[lane], rows.shape[0]
        self._ensure_cap(ln + k)
        self._cond_len[lane] = ln + k
        local = self._local(lane)
        if local is None:                   # another rank's lane
            return self
        rows_dev = device_put_batch(
            gen.fit_cond_stream(rows, gen.next_pow2(k)), self.device)
        spk = int(self._speakers[lane]) if self.cfg.n_speakers else None
        self._cond_buf = _pool_extend(self.params, self._cond_buf, local, ln,
                                      rows_dev, spk)
        return self

    def stop(self, lane: int):
        """Release a lane.  Its slot keeps computing (nobody reads it)
        until ``start()`` reuses it."""
        if lane not in self.active:
            raise ValueError(f"lane {lane} is not active")
        self.active.remove(lane)
        self._free.append(lane)

    # -- decode ----------------------------------------------------------
    def emit(self, n_samples: int) -> torch.Tensor:
        """Advance every lane ``n_samples`` and return [n_lanes, n_samples]
        int32 levels on the device (under a mesh: this rank's lanes
        generated, every rank's gathered)."""
        if n_samples % self.cfg.lookback:
            raise ValueError(f"n_samples must be a multiple of lookback "
                             f"({self.cfg.lookback})")
        cond = self._cond_buf if self.cfg.cond_dim else None
        sampled = self.temperature is not None
        levels, self.states, self.hist = gen.generate_levels(
            self.params, self.cfg, self.n_local, n_samples, self.temperature,
            self.seed, cond=cond, initial_states=self.states,
            hist=self.hist, use_kernels=self.use_kernels, return_state=True,
            cond_pos0=self._cursors,
            lane_keys=self._lane_keys if sampled else None,
            noise_pos0=self._noise_pos, device=self.device,
            kernel_weights=self._weights(self.params))
        self._cursors, self._noise_pos = _advance(self._cursors,
                                                  self._noise_pos, n_samples)
        return pm.gather_batch(self.mesh, levels)

    def emit_waveform(self, n_samples: int) -> torch.Tensor:
        return gen.decode_waveform(self.emit(n_samples), self.cfg)


def host_copy(levels: torch.Tensor):
    """Start copying ``levels`` to the host without waiting: (host tensor,
    event).  On CUDA the host tensor is pinned and the copy is queued on
    the current stream behind the work that produces ``levels``;
    ``host_wait`` then waits for that copy only, not for work queued
    after it (``.cpu()`` issued later would wait for all of it)."""
    if levels.device.type != "cuda":
        return levels, None
    host = torch.empty(levels.shape, dtype=levels.dtype, pin_memory=True)
    host.copy_(levels, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def host_wait(copy) -> np.ndarray:
    """The numpy array of a ``host_copy`` once its copy has landed."""
    host, done = copy
    if done is not None:
        done.synchronize()
    return host.numpy()


def _check_job(job, cfg, temperature) -> dict:
    """One manifest entry validated, with ``n_samples`` resolved."""
    n = job.get("n_samples")
    if n is None:
        if job.get("cond") is None:
            raise ValueError(
                f"job {job['id']!r}: n_samples is required when no cond "
                "stream is given")
        n = int(np.shape(job["cond"])[0]) * cfg.cond_rate
    if int(n) < 1:
        raise ValueError(f"job {job['id']!r}: n_samples must be >= 1")
    if job.get("stream_key") is not None:
        if temperature is None:
            # the pool would refuse it too, but only when the job claims a
            # lane, possibly after earlier jobs streamed out
            raise ValueError(
                f"job {job['id']!r}: stream_key on a greedy run "
                "(temperature=None) — there is no sampling noise to pin")
        if np.shape(_host(job["stream_key"], None)) != (2,):
            raise ValueError(f"job {job['id']!r}: stream_key must be [2] "
                             "uint32 words (noise.lane_key)")
    if job.get("seed_cond") is not None and job.get("seed_levels") is None:
        raise ValueError(f"job {job['id']!r}: seed_cond without seed_levels")
    return dict(job, n_samples=int(n))


def run_jobs(params, cfg: SampleRNNConfig, jobs, *, n_lanes: int,
             chunk: int | None = None, temperature: float | None = 1.0,
             seed: int = 0, use_kernels: bool | str | None = None,
             max_cond_frames: int = 1024, enqueue_ahead: bool = True,
             on_done=None, retain_results: bool = True, device=None,
             mesh=None):
    """Continuous-batching batch synthesis: drain a list of variable-length
    jobs through one :class:`StreamPool` of ``n_lanes`` lanes, one
    generation call per chunk for all lanes.  Each job claims a free lane,
    runs for its own length and frees the slot at a chunk boundary, so no
    lane waits for the longest job of a fixed batch.

    Every job's length is known at its start, so the join/leave schedule
    is fixed in chunk indices and the loop runs enqueue-ahead (with
    ``enqueue_ahead``): chunk t+1 is launched before chunk t is read (the
    pool's lifecycle builds new state tensors, so a join never races a
    queued chunk).  Each chunk goes to pinned host memory behind its own
    launch (``host_copy``), and reading it waits for that copy alone.

    jobs: dicts with the keys (all optional unless noted)
      ``id``          result key (default: the index)
      ``n_samples``   samples to generate; required unless ``cond`` is
                      given, which sets it to ``cond_rows * cfg.cond_rate``
      ``cond``        [frames, cond_dim] conditioning stream
      ``speaker``     int id (required iff the model has n_speakers)
      ``seed_levels`` [L] int prompt the lane continues (``n_samples``
                      counts the continuation only)
      ``seed_cond``   [frames, cond_dim] rows covering the prompt
      ``stream_key``  [2] uint32 words pinning the job's sampling noise (a
                      solo ``StreamingGenerator(stream_keys=key)``
                      reproduces the job bit for bit)

    The whole manifest is validated before any work starts.  Returns
    ``(results, stats)``: results maps id -> int32 [n_samples] levels
    (``generate.decode_waveform`` makes audio of them); stats has ``jobs``,
    ``chunks`` (generation calls), ``chunk`` (samples per lane per call),
    ``lanes``, ``generated`` (requested samples), ``dispatched`` (lane
    samples computed), ``utilization`` (their ratio) and ``wall_s``.
    ``on_done(id, levels)`` fires as each job's last chunk is read;
    ``retain_results=False`` keeps no audio (results is empty) for a
    consumer that streams jobs out through ``on_done``.  ``mesh``: the
    pool's lanes split over its ``data`` axis; every rank runs the same
    schedule and returns the same results."""
    import time

    jobs = list(jobs)
    chunk = int(chunk) if chunk else cfg.lookback
    if chunk % cfg.lookback:
        raise ValueError(f"chunk ({chunk}) must be a multiple of lookback "
                         f"({cfg.lookback})")
    queue = [_check_job(dict(job, id=job.get("id", i)), cfg, temperature)
             for i, job in enumerate(jobs)]
    ids = [j["id"] for j in queue]
    if len(set(ids)) != len(ids):
        raise ValueError("job ids must be unique")
    want = {j["id"]: j["n_samples"] for j in queue}
    requested = sum(want.values())
    queue.reverse()                       # pop() takes jobs in order

    pool = StreamPool(params, cfg, n_lanes=n_lanes, temperature=temperature,
                      seed=seed, use_kernels=use_kernels,
                      max_cond_frames=max_cond_frames, device=device,
                      mesh=mesh)
    results: dict = {}
    pieces: dict = {}                     # id -> [numpy chunk, ...]
    got: dict = {}                        # id -> samples read so far
    active: dict = {}                     # lane -> [id, samples to launch]
    inflight: list = []                   # [(host_copy, {lane: id})]
    depth = 1 if enqueue_ahead else 0
    n_chunks = 0

    def drain(entry):
        copy, snapshot = entry
        arr = host_wait(copy)
        for lane, jid in snapshot.items():
            # a copy: arr[lane] is a view of the whole batch, which one
            # long job would otherwise keep alive for its lifetime
            pieces[jid].append(arr[lane].copy())
            got[jid] += chunk
            if got[jid] >= want[jid]:
                out = np.concatenate(pieces.pop(jid))[:want[jid]]
                if retain_results:
                    results[jid] = out
                if on_done is not None:
                    on_done(jid, out)

    t0 = time.perf_counter()
    while queue or active:
        while queue and len(pool.active) < pool.n:
            job = queue.pop()
            lane = pool.start(
                cond=job.get("cond"), speaker=job.get("speaker"),
                seed_levels=job.get("seed_levels"),
                seed_cond=job.get("seed_cond"),
                stream_key=job.get("stream_key"))
            active[lane] = [job["id"], job["n_samples"]]
            pieces[job["id"]], got[job["id"]] = [], 0
        snapshot = {lane: jid for lane, (jid, _) in active.items()}
        levels = pool.emit(chunk)
        n_chunks += 1
        # lanes whose jobs end with this chunk free their slot now (stop()
        # is bookkeeping; the queued chunk keeps the state it was launched
        # with), so the next joins need not wait for it to be read
        for lane in list(active):
            active[lane][1] -= chunk
            if active[lane][1] <= 0:
                pool.stop(lane)
                del active[lane]
        inflight.append((host_copy(levels), snapshot))
        while len(inflight) > depth:
            drain(inflight.pop(0))
    for entry in inflight:
        drain(entry)
    dispatched = n_chunks * chunk * n_lanes
    stats = {
        "jobs": len(jobs), "chunks": n_chunks, "chunk": chunk,
        "lanes": n_lanes, "generated": requested, "dispatched": dispatched,
        "utilization": requested / dispatched if n_chunks else 0.0,
        "wall_s": time.perf_counter() - t0,
    }
    return results, stats


def _host(x, dtype=np.float32) -> np.ndarray:
    """A tensor or array-like as a numpy array (of ``dtype`` when given)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)

"""Typed configs: a copy of ``samplernn_pase_tpu.config``.

The port keeps its own copy so that it never imports the JAX package,
whose ``__init__`` pulls in all of JAX.  The dataclasses, their defaults,
properties, JSON round-trip and ``preset()`` are the same field for
field; tests/test_torch_config_ops.py holds the two copies together.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


def _tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


@dataclass(frozen=True)
class SampleRNNConfig:
    """SampleRNN model hyperparameters (C7).

    frame_sizes is ordered bottom -> top like the reference's
    ``--frame_sizes`` flag: frame_sizes[0] is both the bottom frame tier's
    frame size and the sample-level MLP's receptive window; tier k spans
    prod(frame_sizes[:k+1]) samples per step; lookback = prod(frame_sizes).
    """

    frame_sizes: Tuple[int, ...] = (16, 4)
    dim: int = 1024
    n_rnn: int = 1                  # RNN layers per tier
    rnn_type: str = "gru"           # "gru" | "lstm"
    q_levels: int = 256
    embed_dim: int = 256            # sample-embedding size (reference: q_levels)
    mlp_hidden: int = 0             # 0 = dim; the sample-MLP hidden width
                                    # MUST equal dim (bottom-tier cond is
                                    # added onto the first hidden layer,
                                    # §3.4) — any other value raises
    cond_dim: int = 0               # 0 = unconditional; else PASE embedding dim
    cond_rate: int = 0              # samples per conditioning frame (e.g. 160)
    n_speakers: int = 0             # >0: learned speaker-lookup table whose
                                    # embedding adds onto the conditioning
                                    # stream (C12 "speaker one-hot/lookup")
    learn_h0: bool = True
    remat: bool = False             # jax.checkpoint each tier: trades
                                    # recompute for activation memory on
                                    # long TBPTT chunks
    pallas_train_rnn: bool | str = "auto"
                                    # GRU sequence kernel (K4, its own
                                    # backward) for tier scans in
                                    # training. "auto" = on for CUDA
                                    # tensors; True = also the kernel's
                                    # plain versions on CPU tensors; on
                                    # CUDA a tier it cannot take raises
                                    # (models/samplernn.py); False = the
                                    # autograd scan everywhere
    weight_norm: bool = False       # weight_norm on projections (C20)
    codec: str = "mulaw"            # "mulaw" | "linear" quantizer (C1)
    compute_dtype: str = "bfloat16"  # matmul dtype; state/softmax stay f32

    def __post_init__(self):
        object.__setattr__(self, "frame_sizes", _tuple(self.frame_sizes))
        if self.mlp_hidden not in (0, self.dim):
            raise ValueError(
                f"mlp_hidden={self.mlp_hidden} must equal dim={self.dim} "
                "(or 0 = dim): the bottom tier's conditioning rows add "
                "directly onto the sample-MLP's first hidden layer")

    @property
    def lookback(self) -> int:
        out = 1
        for f in self.frame_sizes:
            out *= f
        return out

    @property
    def n_tiers(self) -> int:
        return len(self.frame_sizes)

    @property
    def tier_spans(self) -> Tuple[int, ...]:
        """Samples covered by one step of each tier, bottom -> top."""
        spans, acc = [], 1
        for f in self.frame_sizes:
            acc *= f
            spans.append(acc)
        return tuple(spans)


@dataclass(frozen=True)
class PASEConfig:
    """PASE waveform encoder (C8/C9): SincNet front-end + strided conv trunk.

    Defaults follow the PASE paper shape: total decimation 160 so a 16 kHz
    waveform becomes 100 Hz embeddings (SURVEY.md §2 C9).
    """

    sinc_filters: int = 64
    sinc_kernel: int = 251
    sample_rate: int = 16_000
    min_low_hz: float = 50.0
    min_band_hz: float = 50.0
    # (out_channels, kernel, stride) per conv block after the sinc layer
    blocks: Tuple[Tuple[int, int, int], ...] = (
        (64, 20, 10),
        (128, 11, 2),
        (128, 11, 1),
        (256, 11, 2),
        (256, 11, 1),
        (512, 11, 2),
        (512, 11, 2),
    )
    emb_dim: int = 256
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        object.__setattr__(
            self, "blocks", tuple(tuple(b) for b in self.blocks)
        )

    @property
    def decimation(self) -> int:
        out = 1
        for _, _, s in self.blocks:
            out *= s
        return out


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    seq_len: int = 1024            # TBPTT chunk length in samples
    lr: float = 1e-3
    lr_schedule: str = "constant"  # constant | cosine | exponential
    warmup_steps: int = 0
    decay_steps: int = 100_000
    grad_clip: float = 1.0
    steps_per_call: int = 1        # TBPTT chunks per Trainer group: >1
                                   # stages K batches on the device in one
                                   # copy, runs them as K steps in one
                                   # call and reads their NLLs in one host
                                   # sync
    shuffle: bool = False          # permute utterance->lane per epoch
    profile_dir: str = ""          # torch.profiler trace of steps 10-12
    epochs: int = 10
    seed: int = 0
    sample_rate: int = 16_000
    dataset_path: str = ""
    exp_dir: str = "exp/default"
    ckpt_every_steps: int = 500
    val_every_steps: int = 500
    log_every_steps: int = 10
    generate_every_steps: int = 0   # 0 = off
    generate_length: int = 16_000
    max_to_keep: int = 3
    mesh_shape: Tuple[int, ...] = (1,)   # (data,) or (data, model)
    mesh_axes: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        object.__setattr__(self, "mesh_shape", _tuple(self.mesh_shape))
        object.__setattr__(self, "mesh_axes", _tuple(self.mesh_axes))


@dataclass(frozen=True)
class GenerateConfig:
    n_seqs: int = 128
    length: int = 16_000
    temperature: float = 1.0
    seed: int = 0
    sample_rate: int = 16_000


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level config = model (+ optional PASE) + train + generate."""

    model: SampleRNNConfig = field(default_factory=SampleRNNConfig)
    pase: PASEConfig | None = None
    train: TrainConfig = field(default_factory=TrainConfig)
    generate: GenerateConfig = field(default_factory=GenerateConfig)
    name: str = "default"


def to_json(cfg) -> str:
    def default(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        raise TypeError(type(o))

    return json.dumps(dataclasses.asdict(cfg), indent=2, default=default)


def from_json(text: str) -> ExperimentConfig:
    raw = json.loads(text)
    pase = PASEConfig(**raw["pase"]) if raw.get("pase") else None
    return ExperimentConfig(
        model=SampleRNNConfig(**raw["model"]),
        pase=pase,
        train=TrainConfig(**raw["train"]),
        generate=GenerateConfig(**raw["generate"]),
        name=raw.get("name", "default"),
    )


def load_config(path) -> ExperimentConfig:
    with open(path) as f:
        return from_json(f.read())


def preset(name: str) -> ExperimentConfig:
    """The five BASELINE acceptance configs (BASELINE.json:6-10)."""
    if name == "c1_tiny_cpu":
        # 1: 2-tier SampleRNN (frame GRU + sample MLP, 8-bit mu-law),
        #    teacher-forced on one LJSpeech-style clip, CPU.
        return ExperimentConfig(
            name=name,
            model=SampleRNNConfig(frame_sizes=(16, 4), dim=256, rnn_type="gru",
                                  embed_dim=64, mlp_hidden=256),
            train=TrainConfig(batch_size=1, seq_len=1024, lr=2e-3, epochs=50),
        )
    if name == "c2_3tier_lstm":
        # 2: 3-tier SampleRNN with LSTM tiers, TBPTT on 16 kHz batches.
        return ExperimentConfig(
            name=name,
            model=SampleRNNConfig(frame_sizes=(16, 4, 4), dim=1024,
                                  rnn_type="lstm"),
            train=TrainConfig(batch_size=64, seq_len=1024),
        )
    if name == "c3_pase_extract":
        # 3: PASE encoder batched embedding extraction.
        return ExperimentConfig(name=name, pase=PASEConfig())
    if name == "c4_tts_conditioned":
        # 4: PASE-conditioned SampleRNN TTS, end-to-end training.
        p = PASEConfig()
        return ExperimentConfig(
            name=name,
            model=SampleRNNConfig(frame_sizes=(16, 4), dim=1024,
                                  cond_dim=p.emb_dim, cond_rate=p.decimation),
            pase=p,
            train=TrainConfig(batch_size=32, seq_len=1280),
        )
    if name == "c5_gen_b128":
        # 5: batched autoregressive generation, batch 128, temperature.
        return ExperimentConfig(
            name=name,
            model=SampleRNNConfig(frame_sizes=(16, 4), dim=1024),
            generate=GenerateConfig(n_seqs=128, length=16_000, temperature=0.95),
        )
    raise KeyError(name)


PRESETS = (
    "c1_tiny_cpu",
    "c2_3tier_lstm",
    "c3_pase_extract",
    "c4_tts_conditioned",
    "c5_gen_b128",
)

"""Model configuration dataclasses (a copy of `gsoc_wav2vec2_tpu/models/config.py`,
kept here so the port never imports the JAX package).

Field names, defaults and the JSON schema intentionally match the reference
(the reference's `src/wav2vec2/config.py:7-73`) so that `config.json` files
written by the reference load unchanged (including the `kernal_sizes` typo,
which is part of the on-disk contract).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field, replace
from typing import List


@dataclass
class Wav2Vec2Config:
    """Hyper-parameters for the wav2vec2 "base" family.

    JSON round-trip contract: reference `config.py:51-60`.
    Validation contract: reference `config.py:40-49`.
    """

    vocab_size: int = 32
    dropout: float = 0.1
    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 12
    intermediate_size: int = 3072
    is_gelu_approx: bool = False
    layer_norm_eps: float = 1e-5
    survival_prob: float = 1.0
    pad_id: int = 0

    # positional embedding
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16

    # feature extractor
    filter_sizes: List[int] = field(
        default_factory=lambda: [512, 512, 512, 512, 512, 512, 512]
    )
    kernal_sizes: List[int] = field(default_factory=lambda: [10, 3, 3, 3, 3, 2, 2])
    strides: List[int] = field(default_factory=lambda: [5, 2, 2, 2, 2, 2, 2])
    conv_bias: bool = False

    # spec augmentation
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    # feature-axis masking (EXTENSION — absent from the reference; HF
    # fine-tuning recipes' `mask_feature_prob`: random spans of hidden
    # dims are zeroed across all time steps of a sample).  Default off.
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0

    attention_norm_type: str = "postnorm"
    feature_extractor_norm_type: str = "group"
    is_robust: bool = False

    # EXTENSION — LayerNorm before the feature projection (always present
    # in wav2vec2; some HuBERT-family checkpoints, e.g. distilhubert-style
    # configs, set HF's `feat_proj_layer_norm=False`).  Default matches the
    # reference exactly.
    feat_proj_layer_norm: bool = True

    # Fields the reference's config dataclass does not know: excluded from
    # config.json when at their defaults so a dir saved here still loads
    # through the reference's `cls(**json)` (`config.py:57-60`).
    _EXTENSION_FIELDS = (
        "mask_feature_prob", "mask_feature_length", "mask_feature_min_masks",
        "feat_proj_layer_norm",
    )

    def __post_init__(self):
        if not (len(self.filter_sizes) == len(self.kernal_sizes) == len(self.strides)):
            raise ValueError(
                "Length of filter_sizes, kernal_sizes, strides must match."
            )
        if not 0.0 <= self.mask_feature_prob <= 1.0:
            raise ValueError("mask_feature_prob must be in [0, 1]")
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("Hidden size must be perfect multiple of num_heads.")
        if self.feature_extractor_norm_type not in ("group", "layer"):
            raise ValueError("Only `group` / `layer` are supported")
        if self.attention_norm_type not in ("prenorm", "postnorm"):
            raise ValueError("Only `prenorm` / `postnorm` are supported")

    # -- derived helpers -------------------------------------------------

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    def conv_output_length(self, input_length):
        """Number of encoder frames produced from `input_length` waveform samples.

        Same arithmetic as the reference (`modeling.py:203-204`,
        `losses.py:47-56`): per conv layer `1 + (len - kernel) // stride`.
        Works on Python ints and on traced jnp arrays alike.
        """
        length = input_length
        for kernel, stride in zip(self.kernal_sizes, self.strides):
            length = 1 + (length - kernel) // stride
        return length

    # -- persistence ------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON payload: all fields, minus extension fields still at their
        defaults (keeps reference load-back compatibility; a non-default
        extension value IS written — the dir then needs this framework)."""
        d = asdict(self)
        from dataclasses import MISSING, fields

        defaults = {
            f.name: (
                f.default if f.default is not MISSING else f.default_factory()
            )
            for f in fields(self)
        }
        for name in self._EXTENSION_FIELDS:
            if d.get(name) == defaults[name]:
                del d[name]
        return d

    def save_pretrained(self, save_dir: str) -> None:
        if "://" in save_dir:
            # remote (gs://...) destination: os.makedirs would create a
            # literal local "gs:/" directory
            import fsspec

            with fsspec.open(f"{save_dir.rstrip('/')}/config.json", "w") as f:
                json.dump(self.to_dict(), f)
            return
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def from_json(cls, path: str) -> "Wav2Vec2Config":
        if "://" in path:
            import fsspec

            with fsspec.open(path, "r") as f:
                return cls(**json.load(f))
        with open(path, "r") as f:
            config_dict = json.load(f)
        return cls(**config_dict)

    def replace(self, **kwargs) -> "Wav2Vec2Config":
        return replace(self, **kwargs)


def is_hf_config_dict(d: dict) -> bool:
    """Does this config.json payload use the HuggingFace `transformers`
    schema (vs this framework's / the reference's)?  HF payloads carry
    `model_type` and HF-only field names."""
    return "model_type" in d or "num_hidden_layers" in d


def config_from_hf_dict(d: dict):
    """Translate an HF `transformers` config payload (model_type wav2vec2
    or hubert) into this framework's config classes.

    This is what lets `from_pretrained` consume a RAW HF snapshot
    (config.json + pytorch weights) directly — the reference needed its
    separate converter run first (`convert_torch_to_tf.py`).  Only
    architecture fields map; HF's per-site dropout split collapses onto
    the single `dropout` the reference models (training hyper-parameters
    are supplied by the training CLI, not the checkpoint)."""
    model_type = d.get("model_type", "wav2vec2")
    if model_type not in ("wav2vec2", "hubert"):
        raise ValueError(
            f"unsupported HF model_type {model_type!r} (wav2vec2/hubert)"
        )
    stable = bool(d.get("do_stable_layer_norm", False))
    cls = RobustWav2Vec2Config if stable else Wav2Vec2Config
    return cls(
        vocab_size=d.get("vocab_size", 32),
        hidden_size=d.get("hidden_size", 768),
        num_heads=d.get("num_attention_heads", 12),
        num_layers=d.get("num_hidden_layers", 12),
        intermediate_size=d.get("intermediate_size", 3072),
        filter_sizes=list(d.get("conv_dim", [512] * 7)),
        kernal_sizes=list(d.get("conv_kernel", [10, 3, 3, 3, 3, 2, 2])),
        strides=list(d.get("conv_stride", [5, 2, 2, 2, 2, 2, 2])),
        conv_bias=bool(d.get("conv_bias", False)),
        num_conv_pos_embeddings=d.get("num_conv_pos_embeddings", 128),
        num_conv_pos_embedding_groups=d.get("num_conv_pos_embedding_groups", 16),
        layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        attention_norm_type="prenorm" if stable else "postnorm",
        feature_extractor_norm_type=d.get("feat_extract_norm", "group"),
        is_robust=stable,
        feat_proj_layer_norm=bool(d.get("feat_proj_layer_norm", True)),
        apply_spec_augment=bool(d.get("apply_spec_augment", True)),
        mask_time_prob=d.get("mask_time_prob", 0.05),
        mask_time_length=d.get("mask_time_length", 10),
        mask_feature_prob=d.get("mask_feature_prob", 0.0),
        mask_feature_length=d.get("mask_feature_length", 10),
        mask_feature_min_masks=d.get("mask_feature_min_masks", 0),
        pad_id=d.get("pad_token_id", 0),
    )


def config_from_dict(d: dict) -> Wav2Vec2Config:
    """The config of a `config.json` payload: this framework's schema (the
    robust class where `is_robust`) or HF's."""
    if is_hf_config_dict(d):
        return config_from_hf_dict(d)
    config = Wav2Vec2Config(**d)
    if config.is_robust:
        config = RobustWav2Vec2Config(**config.__dict__)
    return config


@dataclass
class Wav2Vec2PretrainingConfig(Wav2Vec2Config):
    """Self-supervised pretraining hyper-parameters (wav2vec2 paper §3.2).

    BEYOND the reference: thevasudevgupta/gsoc-wav2vec2 only fine-tunes from
    already-pretrained checkpoints; these fields cover the pretraining
    objective itself (Gumbel-quantized targets + contrastive/diversity loss).
    Field names and defaults mirror `transformers.Wav2Vec2Config` so HF
    pretraining checkpoints (e.g. facebook/wav2vec2-base) convert 1:1.
    """

    num_codevector_groups: int = 2
    num_codevectors_per_group: int = 320
    codevector_dim: int = 256
    proj_codevector_dim: int = 256
    contrastive_logits_temperature: float = 0.1
    num_negatives: int = 100
    diversity_loss_weight: float = 0.1
    feat_quantizer_dropout: float = 0.0
    # pretraining masks much more aggressively than fine-tuning SpecAugment
    mask_time_prob: float = 0.65

    def __post_init__(self):
        super().__post_init__()
        if self.codevector_dim % self.num_codevector_groups != 0:
            raise ValueError(
                "`codevector_dim` must be divisible by `num_codevector_groups`"
            )
        if not self.feat_proj_layer_norm:
            # the quantizer consumes the NORMED conv features
            # (`models/pretraining.py`); without the projection LayerNorm
            # the objective is undefined — fail at config time, not inside
            # the traced forward
            raise ValueError("pretraining requires feat_proj_layer_norm=True")

    @property
    def num_codevectors(self) -> int:
        return self.num_codevector_groups * self.num_codevectors_per_group


@dataclass
class RobustWav2Vec2Config(Wav2Vec2Config):
    """wav2vec2 "robust"/"large" family (also covers XLSR-53).

    Reference `config.py:64-73`.
    """

    attention_norm_type: str = "prenorm"
    feature_extractor_norm_type: str = "layer"
    is_robust: bool = True
    conv_bias: bool = True

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    num_layers: int = 24


@dataclass
class RobustWav2Vec2PretrainingConfig(Wav2Vec2PretrainingConfig):
    """Pretraining at the large/XLSR geometry (24 pre-norm layers, 1024-d,
    768-d codevectors — `facebook/wav2vec2-large`'s quantizer dims).

    The geometry overrides repeat `RobustWav2Vec2Config`'s on purpose:
    dataclass diamond inheritance cannot merge two field-override sets
    (each decorated class snapshots its full inherited field dict, so one
    base's overrides always clobber the other's).  A consistency test pins
    the two classes together
    (`tests/test_config_and_processor.py::test_robust_pretraining_geometry_matches_robust`).
    """

    attention_norm_type: str = "prenorm"
    feature_extractor_norm_type: str = "layer"
    is_robust: bool = True
    conv_bias: bool = True

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    num_layers: int = 24

    codevector_dim: int = 768
    proj_codevector_dim: int = 768

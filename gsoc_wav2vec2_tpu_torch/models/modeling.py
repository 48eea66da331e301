"""PyTorch implementation of Wav2Vec2 (counterpart of
`gsoc_wav2vec2_tpu/models/modeling.py`).

`nn.Module`s hold the parameters under the JAX parameter tree's names and
layouts (dense kernels (in, out), conv kernels (K, C_in // groups, C_out),
norms `gamma`/`beta`, the pos-conv weight-norm pair `weight_v`/`weight_g`),
with the encoder layers in an `nn.ModuleList` where JAX stacks them for
`lax.scan`.  So `convert/jax_bridge.py` is a pure restacking, and each
state-dict name is the JAX key path joined with dots.

The forward passes are plain functions with the JAX names, taking the
module as `params`.  `compute_dtype` works as in JAX: f32 master weights,
each weight cast to the compute dtype where it is used, norm affine and
weight-norm g/v applied in f32, logits returned in f32.  On a CUDA device
the compute dtype is bf16 and the four kernel sites (conv front end, its
statistics, positional conv, attention) run in the port's Hopper kernels;
on the CPU every site runs its plain PyTorch version.

This slice is inference only: no dropout, no SpecAugment, no stochastic
depth, and the parameters do not require gradients (the kernels have no
backward yet).
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Union

import torch
from torch import nn

from ..convert.hf_torch import state_dict_from_hf
from ..ops.attention import mask_to_bias, mha
from ..ops.basic import dense, gelu, group_norm, layer_norm
from ..ops.conv import conv1d, init_weight_g, pos_conv_embed
from ..ops.kernels import conv_frontend
from ..utils.devices import resolve_device
from .config import RobustWav2Vec2Config, Wav2Vec2Config, config_from_hf_dict, is_hf_config_dict

HF_WEIGHTS_NAME = "pytorch_model.bin"


def default_compute_dtype(device: Union[str, torch.device]) -> torch.dtype:
    """bf16 on the card (the only dtype its kernels take), f32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


# ---------------------------------------------------------------------------
# Parameter containers (initialised on the CPU from an explicit generator)
# ---------------------------------------------------------------------------


def _glorot(shape, gen: torch.Generator) -> torch.Tensor:
    """Glorot-uniform over the last two axes, receptive field in front (as
    `jax.nn.initializers.glorot_uniform(in_axis=-2, out_axis=-1)`)."""
    receptive = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(_glorot((in_dim, out_dim), gen))
        self.bias = nn.Parameter(torch.zeros(out_dim))


class Norm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))


class Conv(nn.Module):
    def __init__(self, kernel: int, in_dim: int, out_dim: int, bias: bool, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(_glorot((kernel, in_dim, out_dim), gen))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None


class ConvLayer(nn.Module):
    def __init__(self, conv: Conv, norm: Optional[Norm]):
        super().__init__()
        self.conv = conv
        self.layer_norm = norm


class FeatureEncoder(nn.Module):
    """The 7 strided conv blocks (base: GroupNorm on layer 0 only; robust:
    LayerNorm and conv bias on every layer)."""

    def __init__(self, config: Wav2Vec2Config, gen: torch.Generator):
        super().__init__()
        layers, in_dim = [], 1
        for i, (filters, kernel) in enumerate(zip(config.filter_sizes, config.kernal_sizes)):
            has_norm = config.feature_extractor_norm_type == "layer" or i == 0
            layers.append(ConvLayer(
                Conv(kernel, in_dim, filters, config.conv_bias, gen),
                Norm(filters) if has_norm else None,
            ))
            in_dim = filters
        self.conv_layers = nn.ModuleList(layers)


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config, gen: torch.Generator):
        super().__init__()
        conv_out = config.filter_sizes[-1]
        self.layer_norm = Norm(conv_out) if config.feat_proj_layer_norm else None
        self.projection = Dense(conv_out, config.hidden_size, gen)


class PosConv(nn.Module):
    def __init__(self, config: Wav2Vec2Config, gen: torch.Generator):
        super().__init__()
        h, k = config.hidden_size, config.num_conv_pos_embeddings
        v = _glorot((k, h // config.num_conv_pos_embedding_groups, h), gen)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(init_weight_g(v))
        self.bias = nn.Parameter(torch.zeros(h))


class PosConvEmbed(nn.Module):
    def __init__(self, config: Wav2Vec2Config, gen: torch.Generator):
        super().__init__()
        self.conv = PosConv(config, gen)


class Attention(nn.Module):
    def __init__(self, h: int, gen: torch.Generator):
        super().__init__()
        self.q_proj = Dense(h, h, gen)
        self.k_proj = Dense(h, h, gen)
        self.v_proj = Dense(h, h, gen)
        self.out_proj = Dense(h, h, gen)


class FeedForward(nn.Module):
    def __init__(self, h: int, i_dim: int, gen: torch.Generator):
        super().__init__()
        self.intermediate_dense = Dense(h, i_dim, gen)
        self.output_dense = Dense(i_dim, h, gen)


class TransformerLayer(nn.Module):
    """One encoder layer; post-norm (base) or pre-norm (robust)."""

    def __init__(self, config: Wav2Vec2Config, gen: torch.Generator):
        super().__init__()
        h = config.hidden_size
        self.attention = Attention(h, gen)
        self.layer_norm = Norm(h)
        self.feed_forward = FeedForward(h, config.intermediate_size, gen)
        self.final_layer_norm = Norm(h)


class Encoder(nn.Module):
    def __init__(self, config: Wav2Vec2Config, gen: torch.Generator):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(config, gen)
        self.layer_norm = Norm(config.hidden_size)
        self.layers = nn.ModuleList(
            TransformerLayer(config, gen) for _ in range(config.num_layers)
        )


# ---------------------------------------------------------------------------
# Forward passes (plain functions, JAX names)
# ---------------------------------------------------------------------------


def feature_encoder_forward(
    params: FeatureEncoder, config: Wav2Vec2Config, waveform: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, L_samples) -> (B, L_frames, C).  In bf16 the base family's first
    two layers run fused (`ops/kernels/conv_frontend.py`): the kernels on
    the card, their plain versions on the CPU."""
    layers = params.conv_layers
    fused = compute_dtype == torch.bfloat16 and conv_frontend.supports(config)
    if waveform.is_cuda and not fused:
        if config.feature_extractor_norm_type == "layer":
            raise NotImplementedError(
                "the robust/large conv front end has no Hopper kernel yet (it ports Pallas "
                "conv_frontend.py::fused_conv01_robust); run this config on the CPU"
            )
        raise NotImplementedError(
            "on CUDA the conv front end runs only in its fused bf16 kernel, which takes "
            "conv0 k10 s5 and conv1 k3 s2 of equal width with GroupNorm and no bias"
        )
    start = 0
    if fused:
        p0, p1 = layers[0], layers[1]
        x = conv_frontend.fused_conv01(
            waveform, p0.conv.kernel, p0.layer_norm.gamma, p0.layer_norm.beta,
            p1.conv.kernel, eps=1e-5, gelu_approx=True,
        )
        start = 2
    else:
        x = waveform[:, :, None].to(compute_dtype)
    for i in range(start, len(layers)):
        p = layers[i]
        x = conv1d(x, p.conv.kernel, p.conv.bias, stride=config.strides[i])
        if p.layer_norm is not None:
            if config.feature_extractor_norm_type == "group":
                x = group_norm(
                    x, p.layer_norm.gamma, p.layer_norm.beta,
                    groups=config.filter_sizes[i], eps=1e-5,
                )
            else:
                x = layer_norm(x, p.layer_norm.gamma, p.layer_norm.beta, eps=1e-5)
        x = gelu(x, approximate=config.is_gelu_approx)
    return x


def transformer_layer_forward(
    x: torch.Tensor, p: TransformerLayer, config: Wav2Vec2Config,
    mask_bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """One encoder layer at inference (reference `encoder.py:111-134`)."""
    eps = config.layer_norm_eps
    prenorm = config.attention_norm_type == "prenorm"
    residual = x
    if prenorm:
        x = layer_norm(x, p.layer_norm.gamma, p.layer_norm.beta, eps)
    x = mha(x, p.attention, config.num_heads, mask_bias) + residual
    if not prenorm:
        x = layer_norm(x, p.layer_norm.gamma, p.layer_norm.beta, eps)

    residual = x
    if prenorm:
        x = layer_norm(x, p.final_layer_norm.gamma, p.final_layer_norm.beta, eps)
    ff = p.feed_forward
    x = gelu(
        dense(x, ff.intermediate_dense.kernel, ff.intermediate_dense.bias),
        approximate=config.is_gelu_approx,
    )
    # stochastic depth at eval: the plain residual sum, not rescaled
    x = residual + dense(x, ff.output_dense.kernel, ff.output_dense.bias)
    if not prenorm:
        x = layer_norm(x, p.final_layer_norm.gamma, p.final_layer_norm.beta, eps)
    return x


def encoder_forward(
    params: Encoder, config: Wav2Vec2Config, x: torch.Tensor,
    frame_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Positional conv embed + N transformer layers (a loop over the
    `ModuleList` where JAX scans)."""
    mask_bias = None
    if frame_mask is not None:
        x = torch.where(frame_mask[:, :, None], x, torch.zeros_like(x))
        mask_bias = mask_to_bias(frame_mask, torch.float32)
    pc = params.pos_conv_embed.conv
    x = x + pos_conv_embed(
        x, pc.weight_v, pc.weight_g, pc.bias, config.num_conv_pos_embeddings,
        config.num_conv_pos_embedding_groups, config.is_gelu_approx,
    )
    prenorm = config.attention_norm_type == "prenorm"
    ln = params.layer_norm
    if not prenorm:
        x = layer_norm(x, ln.gamma, ln.beta, config.layer_norm_eps)
    for layer in params.layers:
        x = transformer_layer_forward(x, layer, config, mask_bias)
    if prenorm:
        x = layer_norm(x, ln.gamma, ln.beta, config.layer_norm_eps)
    return x


def wav2vec2_forward(
    params: "Wav2Vec2Model", config: Wav2Vec2Config, batch: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None, *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, L_samples) normalised waveform [+ 0/1 sample mask] ->
    (B, L_frames, hidden_size) hidden states."""
    if batch.is_cuda and compute_dtype != torch.bfloat16:
        raise ValueError(f"on CUDA the compute dtype is bf16 (its kernels' only dtype), got {compute_dtype}")
    x = feature_encoder_forward(params.feature_extractor, config, batch, compute_dtype)
    fp = params.feature_projection
    if fp.layer_norm is not None:
        x = layer_norm(x, fp.layer_norm.gamma, fp.layer_norm.beta, config.layer_norm_eps)
    x = dense(x, fp.projection.kernel, fp.projection.bias)

    frame_mask = None
    if attention_mask is not None:
        input_length = attention_mask.to(torch.int64).sum(dim=-1)
        frame_length = config.conv_output_length(input_length)
        frame_mask = torch.arange(x.shape[1], device=x.device)[None, :] < frame_length[:, None]
    return encoder_forward(params.encoder, config, x, frame_mask)


def wav2vec2_for_ctc_forward(
    params: "Wav2Vec2ForCTC", config: Wav2Vec2Config, batch: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None, *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Base model -> LM head; (B, L_frames, vocab) logits in f32."""
    x = wav2vec2_forward(
        params.wav2vec2, config, batch, attention_mask, compute_dtype=compute_dtype
    )
    return dense(x, params.lm_head.kernel, params.lm_head.bias).float()


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _load_config(save_dir: str) -> Wav2Vec2Config:
    with open(os.path.join(save_dir, "config.json")) as f:
        d = json.load(f)
    if is_hf_config_dict(d):
        return config_from_hf_dict(d)
    config = Wav2Vec2Config(**d)
    if config.is_robust:
        config = RobustWav2Vec2Config(**config.__dict__)
    return config


class _Pretrained(nn.Module):
    """Shared construction and `from_pretrained` of the two models."""

    _with_lm_head = False
    _forward = None

    def _setup(self, config, device, generator):
        if not isinstance(config, Wav2Vec2Config):
            raise ValueError("`config` must be an instance of `Wav2Vec2Config`")
        self.config = config
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        return dev, gen

    def _finish(self, dev):
        self.requires_grad_(False)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, batch: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        """Forward in the device's compute dtype (`default_compute_dtype`)."""
        return type(self)._forward(
            self, self.config, batch, attention_mask,
            compute_dtype=default_compute_dtype(batch.device),
        )

    @classmethod
    def from_pretrained(cls, save_dir: str, *, device=None):
        """Load `config.json` (this framework's or the HF schema) and an HF
        `pytorch_model.bin` (read with `torch.load(weights_only=True)`,
        both weight-norm namings)."""
        dev = resolve_device(device)
        config = _load_config(save_dir)
        path = os.path.join(save_dir, HF_WEIGHTS_NAME)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"no {HF_WEIGHTS_NAME} in {save_dir} (msgpack, h5 and safetensors "
                "loading are not ported yet)"
            )
        model = cls(config, device="cpu")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(
            state_dict_from_hf(sd, config, with_lm_head=cls._with_lm_head), strict=True
        )
        return model.to(dev)


class Wav2Vec2Model(_Pretrained):
    """Feature encoder + transformer encoder (no head)."""

    _forward = staticmethod(wav2vec2_forward)

    def __init__(
        self, config: Wav2Vec2Config, *, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        """`device` None means CUDA (raises without it); weights come from
        `generator` (default: seed 0) on the CPU and then move."""
        super().__init__()
        dev, gen = self._setup(config, device, generator)
        h = config.hidden_size
        self.masked_spec_embed = nn.Parameter(torch.rand(h, generator=gen) * 0.1 - 0.05)
        self.feature_extractor = FeatureEncoder(config, gen)
        self.feature_projection = FeatureProjection(config, gen)
        self.encoder = Encoder(config, gen)
        self._finish(dev)


class Wav2Vec2ForCTC(_Pretrained):
    """Wav2Vec2 with a CTC head."""

    _with_lm_head = True
    _forward = staticmethod(wav2vec2_for_ctc_forward)

    def __init__(
        self, config: Wav2Vec2Config, *, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        """As `Wav2Vec2Model`, plus the (hidden, vocab) LM head."""
        super().__init__()
        dev, gen = self._setup(config, device, generator)
        self.wav2vec2 = Wav2Vec2Model(config, device="cpu", generator=gen)
        self.lm_head = Dense(config.hidden_size, config.vocab_size, gen)
        self._finish(dev)

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
the compute dtype is bf16 and the kernel sites (the conv front end of either
family, the base one's statistics, positional conv, attention) run in the
port's Hopper kernels; on the CPU every site runs its plain PyTorch version.

`training=True` is the fine-tuning forward (JAX `modeling.py:176-535`):
dropout at every JAX site, SpecAugment, stochastic depth, attention and the
positional conv through their autograd functions (kernel backwards).  The
randomness comes from one `torch.Generator`, drawn in JAX's key-stream
order: the head's dropout, then the body (projection dropout, SpecAugment,
the encoder's dropout, then 4 draws per layer: attention seed, post-attention
dropout, FFN dropout, stochastic depth, all layers' drawn before the first
runs).  `remat` (False, True / "full", "dots": JAX's values) recomputes each
layer's activations in the backward (`torch.utils.checkpoint`).  Every site
draws whether or not its rate is 0, so the stream does not depend on the
rates.  What is frozen
is what has `requires_grad` off: the models are built so, and
`training.set_trainable` turns on the trainable leaves.  Autograd then
builds no backward for a frozen region (JAX's `stop_gradient` at the same
places), and the attention and positional-conv sites take their
differentiable kernels only where an input needs a gradient.  The fused
conv front end has no backward kernel: where a gradient can reach conv0 or
conv1 (grad enabled and one of their parameters trainable, as in
pretraining) the two layers run as plain convolutions like layers 2-6, which
is the JAX package's own dispatch (`conv_frontend.supports`).
"""

from __future__ import annotations

import functools
import json
import math
import os
import tempfile
from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..convert import flax_msgpack, safetensors_io
from ..convert.hf_torch import state_dict_from_hf
from ..convert.h5_to_torch import load_h5_params
from ..convert.jax_bridge import params_from_jax, params_to_jax
from ..convert.torch_to_h5 import save_h5_params
from ..data import remote
from ..ops.attention import attention_seed, mask_to_bias, mha
from ..ops.basic import dense, dropout, gelu, group_norm, layer_norm, seed_words, stochastic_depth
from ..ops.conv import conv1d, init_weight_g, pos_conv_embed
from ..ops.kernels import conv_frontend
from ..ops.specaugment import apply_feature_masking, apply_spec_augmentation
from ..parallel.mesh import Mesh, global_rows, global_span
from ..parallel.partition import copy_to_model, row_parallel_dense
from ..utils.devices import resolve_device
from .config import Wav2Vec2Config, config_from_dict, is_hf_config_dict

JAX_WEIGHTS_NAME = "jax_model.msgpack"
H5_WEIGHTS_NAME = "tf_model.h5"
SAFETENSORS_NAME = "model.safetensors"
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
    """(B, L_samples) -> (B, L_frames, C).  In bf16 the first two layers run
    fused (`ops/kernels/conv_frontend.py`: `fused_conv01` for the base
    family, `fused_conv01_robust` for the robust/large one, called as their
    `torch.library` operators so that `torch.export` keeps them): the kernels on
    the card where their instances cover the config (`supports`), their
    plain versions on the CPU (`fusable`).  Elsewhere (f32, another width
    on the card) all seven layers run the plain loop, as the JAX package
    falls back to XLA.  The fused kernels have no backward, so where a
    gradient can reach conv0/conv1 the plain loop runs too and autograd
    gives the backward."""
    layers = params.conv_layers
    fusable = compute_dtype == torch.bfloat16 and (
        conv_frontend.supports(config) if waveform.is_cuda else conv_frontend.fusable(config))
    p0, p1 = layers[0], layers[1]
    trains = torch.is_grad_enabled() and any(
        p.requires_grad for p in (*p0.parameters(), *p1.parameters()))
    start = 0
    if fusable and not trains:
        if config.feature_extractor_norm_type == "group":
            x = conv_frontend.fused_conv01_op(
                waveform, p0.conv.kernel, p0.layer_norm.gamma, p0.layer_norm.beta,
                p1.conv.kernel, 1e-5, True,
            )
        else:  # robust/large family: LayerNorm (+ bias) on both layers
            zeros = torch.zeros_like(p0.layer_norm.gamma)
            x = conv_frontend.fused_conv01_robust_op(
                waveform,
                p0.conv.kernel, zeros if p0.conv.bias is None else p0.conv.bias,
                p0.layer_norm.gamma, p0.layer_norm.beta,
                p1.conv.kernel, zeros if p1.conv.bias is None else p1.conv.bias,
                p1.layer_norm.gamma, p1.layer_norm.beta,
                1e-5, True,
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


def _check_training(training: bool, generator: Optional[torch.Generator]) -> None:
    if training and generator is None:
        raise ValueError("the training forward draws its randomness from a torch.Generator")


LayerDraws = Tuple[int, Tuple[int, int], Tuple[int, int], bool]


def layer_draws(generator: torch.Generator, config: Wav2Vec2Config) -> LayerDraws:
    """One training layer's randomness, drawn in JAX's order: the attention
    seed, the post-attention and FFN dropout seeds, the stochastic-depth
    Bernoulli."""
    return (attention_seed(generator), seed_words(generator), seed_words(generator),
            bool(torch.rand((), generator=generator) < config.survival_prob))


def transformer_layer_forward(
    x: torch.Tensor, p: TransformerLayer, config: Wav2Vec2Config,
    mask_bias: Optional[torch.Tensor], *, training: bool = False,
    draws: Optional[LayerDraws] = None, mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """One encoder layer (reference `encoder.py:111-134`); in training it
    takes its randomness as `draws` (`layer_draws`), drawn before the layer
    runs, so that a rematerialised layer recomputes the same bits.  Under a
    `mesh` it is this rank's shard: attention as `mha` runs it, the FFN
    split as `parallel/partition.py` says, each dropout mask this rank's
    block of the one-process mask."""
    if training and draws is None:
        raise ValueError("the training layer takes its draws (layer_draws) from the caller")
    attn_seed, attn_drop, ffn_drop, keep_ffn = draws if training else (None,) * 4
    eps, rate = config.layer_norm_eps, config.dropout
    prenorm = config.attention_norm_type == "prenorm"
    residual = x
    if prenorm:
        x = layer_norm(x, p.layer_norm.gamma, p.layer_norm.beta, eps)
    x = mha(x, p.attention, config.num_heads, mask_bias, dropout_rate=rate, seed=attn_seed,
            training=training, mesh=mesh)
    x = dropout(x, rate, attn_drop, not training, global_span(mesh, x.shape)) + residual
    if not prenorm:
        x = layer_norm(x, p.layer_norm.gamma, p.layer_norm.beta, eps)

    residual = x
    if prenorm:
        x = layer_norm(x, p.final_layer_norm.gamma, p.final_layer_norm.beta, eps)
    ff = p.feed_forward
    x = gelu(
        dense(copy_to_model(x, mesh), ff.intermediate_dense.kernel, ff.intermediate_dense.bias),
        approximate=config.is_gelu_approx,
    )
    x = dropout(x, rate, ffn_drop, not training, global_span(mesh, x.shape, split_last=True))
    # at eval the plain residual sum, not rescaled
    x = stochastic_depth(
        residual, row_parallel_dense(x, ff.output_dense.kernel, ff.output_dense.bias, mesh),
        config.survival_prob, keep_ffn, not training)
    if not prenorm:
        x = layer_norm(x, p.final_layer_norm.gamma, p.final_layer_norm.beta, eps)
    return x


# the matrix products that `remat="dots"` keeps (jax.checkpoint_policies.dots_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(remat: Union[bool, str]):
    """None (no rematerialisation) or the `checkpoint` context function of a
    JAX `remat` value: True / "full" saves nothing inside a layer, "dots"
    saves the matrix products' outputs and recomputes the rest (norms,
    activations, dropout masks, the attention kernel, as a Pallas call is
    recomputed under `dots_saveable`)."""
    if remat is False or remat is None:
        return None
    if remat is True or remat == "full":
        return noop_context_fn
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    raise ValueError(f"remat must be False, True, 'full' or 'dots', got {remat!r}")


def encoder_forward(
    params: Encoder, config: Wav2Vec2Config, x: torch.Tensor,
    frame_mask: Optional[torch.Tensor], *, training: bool = False,
    generator: Optional[torch.Generator] = None, remat: Union[bool, str] = False,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Positional conv embed + N transformer layers (a loop over the
    `ModuleList` where JAX scans).  In training every layer's draws come
    from `generator` before the first layer runs (JAX splits the layers'
    keys before its scan; nothing draws between layers, so the bits are
    those of drawing inside each layer).  `remat` (JAX's values, see
    `remat_policy`) wraps each layer in `torch.utils.checkpoint` where a
    gradient is being recorded: its activations are recomputed in the
    backward, from the same draws."""
    _check_training(training, generator)
    context_fn = remat_policy(remat)
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
    x = dropout(x, config.dropout, seed_words(generator) if training else None, not training,
                global_span(mesh, x.shape))
    draws = [layer_draws(generator, config) if training else None for _ in params.layers]
    for layer, d in zip(params.layers, draws):
        if context_fn is not None and torch.is_grad_enabled():
            x = checkpoint(transformer_layer_forward, x, layer, config, mask_bias,
                           training=training, draws=d, mesh=mesh, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = transformer_layer_forward(x, layer, config, mask_bias, training=training,
                                          draws=d, mesh=mesh)
    if prenorm:
        x = layer_norm(x, ln.gamma, ln.beta, config.layer_norm_eps)
    return x


def wav2vec2_forward(
    params: "Wav2Vec2Model", config: Wav2Vec2Config, batch: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None, *,
    compute_dtype: torch.dtype = torch.float32, training: bool = False,
    generator: Optional[torch.Generator] = None, remat: Union[bool, str] = False,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """(B, L_samples) normalised waveform [+ 0/1 sample mask] ->
    (B, L_frames, hidden_size) hidden states.  `training` and `generator`
    as in the module docstring, `remat` as in `encoder_forward`.  The
    kernels run in bf16; in f32 on the card attention with heads of 64 runs
    the flash kernels' f32 instance (JAX runs its Pallas flash kernels on
    f32 inputs) and every other site its plain torch op, in full f32 when the
    caller sets `torch.backends.cuda.matmul.allow_tf32 = False` and
    `torch.backends.cudnn.allow_tf32 = False` (cuDNN's convolutions
    default to TF32).  Under a `mesh` (`parallel.Mesh`) `batch` holds this
    rank's rows and the encoder runs this rank's shard; every draw made over
    the whole batch (dropout masks, SpecAugment) is the one-process draw's
    block, as JAX draws it under GSPMD."""
    _check_training(training, generator)
    x = feature_encoder_forward(params.feature_extractor, config, batch, compute_dtype)
    fp = params.feature_projection
    if fp.layer_norm is not None:
        x = layer_norm(x, fp.layer_norm.gamma, fp.layer_norm.beta, config.layer_norm_eps)
    x = dense(x, fp.projection.kernel, fp.projection.bias)
    x = dropout(x, config.dropout, seed_words(generator) if training else None, not training,
                global_span(mesh, x.shape))

    if training and config.apply_spec_augment:
        rows = global_rows(mesh, x.shape[0])
        x = apply_spec_augmentation(generator, x, params.masked_spec_embed,
                                    config.mask_time_prob, config.mask_time_length, rows=rows)
        if config.mask_feature_prob > 0:
            x = apply_feature_masking(generator, x, config.mask_feature_prob,
                                      config.mask_feature_length, config.mask_feature_min_masks,
                                      rows=rows)

    frame_mask = None
    if attention_mask is not None:
        input_length = attention_mask.to(torch.int64).sum(dim=-1)
        frame_length = config.conv_output_length(input_length)
        frame_mask = torch.arange(x.shape[1], device=x.device)[None, :] < frame_length[:, None]
    return encoder_forward(params.encoder, config, x, frame_mask, training=training,
                           generator=generator, remat=remat, mesh=mesh)


def wav2vec2_for_ctc_forward(
    params: "Wav2Vec2ForCTC", config: Wav2Vec2Config, batch: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None, *,
    compute_dtype: torch.dtype = torch.float32, training: bool = False,
    generator: Optional[torch.Generator] = None, remat: Union[bool, str] = False,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Base model -> dropout -> LM head; (B, L_frames, vocab) logits in
    f32 (this rank's rows under a `mesh`)."""
    _check_training(training, generator)
    head_seed = seed_words(generator) if training else None
    x = wav2vec2_forward(
        params.wav2vec2, config, batch, attention_mask, compute_dtype=compute_dtype,
        training=training, generator=generator, remat=remat, mesh=mesh,
    )
    x = dropout(x, config.dropout, head_seed, not training, global_span(mesh, x.shape))
    return dense(x, params.lm_head.kernel, params.lm_head.bias).float()


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _join(base: str, name: str) -> str:
    return f"{base.rstrip('/')}/{name}" if remote.is_remote_path(base) else os.path.join(base, name)


def _read_config_json(save_dir: str) -> dict:
    return json.loads(remote.fetch_bytes(_join(save_dir, "config.json")))


class _Pretrained(nn.Module):
    """Shared construction, `save_pretrained` and `from_pretrained` of the
    models."""

    _with_lm_head = False
    _pretraining_heads = False
    _forward = None
    _config_from_dict = staticmethod(config_from_dict)

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

    def save_pretrained(self, save_dir: str, save_h5: bool = False) -> None:
        """Write `config.json` and `jax_model.msgpack`, the parameter tree in
        the layout of `flax.serialization.to_bytes` (encoder layers stacked,
        conv layers keyed "0".."6"), which the JAX package's `from_pretrained`
        reads.  `save_h5=True` also writes the reference's `tf_model.h5`
        (`convert/torch_to_h5.py`), which the reference's Keras
        `from_pretrained` and the JAX package read.  A `scheme://` directory
        is written through fsspec."""
        self.config.save_pretrained(save_dir)
        params = params_to_jax(self.state_dict())
        blob = flax_msgpack.serialize(params)
        path = _join(save_dir, JAX_WEIGHTS_NAME)
        if remote.is_remote_path(save_dir):
            remote.write_bytes(path, blob)
        else:
            with open(path, "wb") as f:
                f.write(blob)
        if save_h5:
            h5_path = _join(save_dir, H5_WEIGHTS_NAME)
            if remote.is_remote_path(save_dir):
                with tempfile.TemporaryDirectory() as tmp:
                    local = os.path.join(tmp, H5_WEIGHTS_NAME)
                    save_h5_params(params, self.config, local, with_lm_head=self._with_lm_head)
                    with open(local, "rb") as f:
                        remote.write_bytes(h5_path, f.read())
            else:
                save_h5_params(params, self.config, h5_path, with_lm_head=self._with_lm_head)

    def push_to_hub(self, directory: str, model_id: str):
        """Create the hub repository `model_id` (if absent) and upload
        `directory` (a `save_pretrained` output) to it; needs
        `huggingface_hub`."""
        try:
            from huggingface_hub import HfApi
        except ImportError as e:
            raise ImportError("push_to_hub requires `huggingface_hub`") from e
        api = HfApi()
        api.create_repo(model_id, exist_ok=True)
        return api.upload_folder(folder_path=directory, repo_id=model_id)

    def _state_dict_from(self, save_dir: str, hf_snapshot: bool) -> dict:
        """The state dict of the first weight file found, in the JAX
        package's order: `jax_model.msgpack`, `tf_model.h5` (the reference's
        layout, read into this model's tree), `model.safetensors`,
        `pytorch_model.bin`.  A `scheme://` directory holds the msgpack only,
        as in the JAX package."""
        path = _join(save_dir, JAX_WEIGHTS_NAME)
        if remote.is_remote_path(save_dir) or os.path.isfile(path):
            return params_from_jax(flax_msgpack.restore(remote.fetch_bytes(path)))
        # an HF snapshot's tf_model.h5 is the TF `transformers` layout, never read
        h5_path = os.path.join(save_dir, H5_WEIGHTS_NAME)
        if not hf_snapshot and os.path.isfile(h5_path):
            template = params_to_jax(self.state_dict())
            return params_from_jax(load_h5_params(h5_path, template,
                                                  with_lm_head=self._with_lm_head))
        config = self.config
        st_path = os.path.join(save_dir, SAFETENSORS_NAME)
        bin_path = os.path.join(save_dir, HF_WEIGHTS_NAME)
        if os.path.isfile(st_path):
            sd = safetensors_io.load_file(st_path)
        elif os.path.isfile(bin_path):
            sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(
                f"No weights found in {save_dir} (looked for {JAX_WEIGHTS_NAME}, "
                f"{H5_WEIGHTS_NAME}, {SAFETENSORS_NAME}, {HF_WEIGHTS_NAME})"
            )
        return state_dict_from_hf(sd, config, with_lm_head=self._with_lm_head,
                                  pretraining=self._pretraining_heads)

    @classmethod
    def from_pretrained(cls, model_id: str, *, device=None, **config_kwargs):
        """Load `config.json` (this framework's or the HF schema) and the
        weights (`_state_dict_from`) from a directory; a `model_id` that is
        neither a local directory nor a `scheme://` one (read through
        fsspec) is downloaded from the HuggingFace Hub first
        (`_download_from_hub`).  Extra keyword arguments are `replace()`d
        into the config, as in the JAX package; `input_shape` is accepted
        and ignored."""
        dev = resolve_device(device)
        save_dir = model_id
        if not remote.is_remote_path(model_id) and not os.path.isdir(model_id):
            save_dir = _download_from_hub(model_id)
        config_kwargs.pop("input_shape", None)
        d = _read_config_json(save_dir)
        config = cls._config_from_dict(d).replace(**config_kwargs)
        model = cls(config, device="cpu")
        model.load_state_dict(model._state_dict_from(save_dir, is_hf_config_dict(d)), strict=True)
        return model.to(dev)


def _download_from_hub(model_id: str) -> str:
    """The local snapshot directory of hub repository `model_id`
    (`huggingface_hub.snapshot_download`, HF flax weights skipped: never
    read here).  Raises `ValueError` naming the id when that fails."""
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download(model_id, ignore_patterns=["flax_model*"])
    except Exception as e:  # any failure of the download: no network, no such repo, no package
        raise ValueError(
            f"`{model_id}` is not a local directory and downloading from the "
            f"HuggingFace Hub failed ({e}). Pass a local path."
        ) from e


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

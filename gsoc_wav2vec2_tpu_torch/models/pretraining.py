"""wav2vec2 self-supervised pretraining: Gumbel quantizer + contrastive loss
(counterpart of `gsoc_wav2vec2_tpu/models/pretraining.py`, same function
names and semantics: `transformers.Wav2Vec2ForPreTraining`'s).

  * quantizer input = the LayerNorm-ed conv features (the projection's
    input, not its output);
  * masked positions take the trainable `masked_spec_embed` before the
    encoder, and the same mask selects the contrastive targets;
  * Gumbel-softmax with straight-through hard one-hots, per-group codebooks;
    perplexity from the noise-free softmax (training) or the one-hots (eval),
    marginalised over masked frames;
  * contrastive logits = cosine similarity / temperature against the true
    quantized target plus K sampled distractors, distractors with the
    target's codewords masked to -inf; cross-entropy summed over masked
    frames; diversity loss = (GV - perplexity) / GV x the masked-frame count.

`Wav2Vec2ForPreTraining` holds the parameters under the JAX tree's names and
layouts (`wav2vec2`, `quantizer.codevectors` (1, G*V, d/G),
`quantizer.weight_proj`, `project_hid`, `project_q`), so
`convert/jax_bridge.py` carries a tree over unchanged.

Randomness comes from one `torch.Generator`, drawn in the JAX forward's key
order: projection dropout, the encoder's draws, quantizer dropout, Gumbel
noise; the step then draws the negatives.  The two draws that are not seed
words live in `_gumbel_noise` and `_uniform_below`.

Under a `mesh` (`parallel.Mesh`, JAX's `mesh=`) each rank computes its rows
of the batch: the Gumbel noise and the negatives are drawn at the global
batch's shape and each rank takes its rows, and the perplexity's marginal is
over the global batch's masked frames (its two sums added over the data
group by an all-reduce whose backward also sums, while each rank's diversity
term counts its own masked frames, so that the terms summed over ranks are
the one-process loss once).  `scatter_rows_add` runs per rank on its local
rows, as JAX's `shard_map` branch does; the rows are local by construction,
and `parallel.multihost.host_local_batch_to_global` raises where a global
batch does not divide the data axis (JAX's error at the kernel).

Against the JAX module: `attention_impl` and `use_pallas` have no
counterpart; `remat` takes JAX's values; the step takes the optimizer from
the port's `TrainState` where JAX takes an optax `tx`; `pretraining_loss`'s
`pallas_scatter` is `scatter_kernel` here.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ..ops.basic import dense, dropout, layer_norm, seed_words
from ..ops.kernels import scatter_add
from ..parallel.mesh import Mesh, global_rows, global_span
from ..parallel.partition import all_reduce_sum
from ..training.state import TrainState
from ..training.trainer import _apply, _to_device, data_sum
from .config import (
    RobustWav2Vec2PretrainingConfig,
    Wav2Vec2PretrainingConfig,
    config_from_hf_dict,
    is_hf_config_dict,
)
from .modeling import (
    Dense,
    Wav2Vec2ForCTC,
    Wav2Vec2Model,
    _check_training,
    _Pretrained,
    default_compute_dtype,
    encoder_forward,
    feature_encoder_forward,
)


class GumbelQuantizer(nn.Module):
    """Codebooks (1, G*V, d/G) ~ U[0, 1) and the logit projection, kernel
    ~ N(0, 1) with zero bias (HF `_init_weights`)."""

    def __init__(self, config: Wav2Vec2PretrainingConfig, gen: torch.Generator):
        super().__init__()
        g, v = config.num_codevector_groups, config.num_codevectors_per_group
        conv_dim = config.filter_sizes[-1]
        self.codevectors = nn.Parameter(
            torch.rand((1, g * v, config.codevector_dim // g), generator=gen))
        self.weight_proj = Dense(conv_dim, g * v, gen)
        with torch.no_grad():
            self.weight_proj.kernel.copy_(torch.randn((conv_dim, g * v), generator=gen))


_HF_PRETRAINING_FIELDS = (
    "num_codevector_groups", "num_codevectors_per_group", "codevector_dim",
    "proj_codevector_dim", "contrastive_logits_temperature", "num_negatives",
    "diversity_loss_weight", "feat_quantizer_dropout",
)


def _pretraining_config_from_dict(d: dict) -> Wav2Vec2PretrainingConfig:
    """A `config.json` payload in this framework's schema or HF's (whose
    pretraining fields have the same names)."""
    if is_hf_config_dict(d):
        fields = dict(config_from_hf_dict(d).__dict__)
        fields.update({k: d[k] for k in _HF_PRETRAINING_FIELDS if k in d})
    else:
        fields = d
    cls = RobustWav2Vec2PretrainingConfig if fields.get("is_robust") else Wav2Vec2PretrainingConfig
    return cls(**fields)


class Wav2Vec2ForPreTraining(_Pretrained):
    """Backbone + quantizer + the two projection heads (glorot-uniform);
    `save_pretrained` / `from_pretrained` as the CTC model (msgpack of the
    JAX pretraining tree; HF `Wav2Vec2ForPreTraining` safetensors or
    `pytorch_model.bin`)."""

    _pretraining_heads = True
    _config_from_dict = staticmethod(_pretraining_config_from_dict)

    def __init__(
        self, config: Wav2Vec2PretrainingConfig, *, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        """As `Wav2Vec2Model`: `device` None means CUDA, weights from
        `generator` (default: seed 0) on the CPU and then moved."""
        super().__init__()
        if not isinstance(config, Wav2Vec2PretrainingConfig):
            raise ValueError("`config` must be an instance of `Wav2Vec2PretrainingConfig`")
        dev, gen = self._setup(config, device, generator)
        self.wav2vec2 = Wav2Vec2Model(config, device="cpu", generator=gen)
        self.quantizer = GumbelQuantizer(config, gen)
        self.project_hid = Dense(config.hidden_size, config.proj_codevector_dim, gen)
        self.project_q = Dense(config.codevector_dim, config.proj_codevector_dim, gen)
        self._finish(dev)

    def forward(self, batch: torch.Tensor, mask_time_indices: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        """Eval-mode forward in the device's compute dtype."""
        return wav2vec2_for_pretraining_forward(
            self, self.config, batch, mask_time_indices, attention_mask,
            compute_dtype=default_compute_dtype(batch.device),
        )


def _perplexity(probs: torch.Tensor, mask: Optional[torch.Tensor],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`Wav2Vec2GumbelVectorQuantizer._compute_perplexity`: probs (N, G, V),
    mask (N,) frame validity -> the summed per-group exp-entropy of the
    masked marginals.  Under a `mesh` the marginal is the global batch's:
    the sums are added over the data group (`all_reduce_sum`)."""
    group = None if mesh is None or mesh.data == 1 else mesh.data_group
    if mask is not None:
        m = mask.reshape(-1, 1, 1).to(probs.dtype)
        num, den = (probs * m).sum(dim=0), m.sum()
    elif group is None:
        return _entropy_perplexity(probs.mean(dim=0))
    else:
        num, den = probs.sum(dim=0), torch.tensor(float(probs.shape[0]), device=probs.device)
    if group is not None:
        sums = all_reduce_sum(torch.cat([num.reshape(-1), den.reshape(1)]), group)
        num, den = sums[:-1].reshape(num.shape), sums[-1]
    if mask is None:
        return _entropy_perplexity(num / den)
    return _entropy_perplexity(num / den.clamp_min(1.0))


def _entropy_perplexity(marginal: torch.Tensor) -> torch.Tensor:
    return torch.exp(-(marginal * torch.log(marginal + 1e-7)).sum(dim=-1)).sum()


def _gumbel_noise(generator: torch.Generator, shape, device,
                  block: slice = slice(None)) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u), u ~ U(0, 1) from `generator`;
    `block`: the leading-axis rows of the draw to keep (a rank's share of the
    global batch's), taken before the logs and the copy to `device`."""
    u = torch.rand(shape, generator=generator, device=generator.device)[block]
    tiny = torch.finfo(u.dtype).tiny
    e = (-torch.log(u.clamp_min(tiny))).clamp_min(tiny)  # standard exponential, > 0
    return (-torch.log(e)).to(device)


def gumbel_vector_quantizer(
    params: GumbelQuantizer, config: Wav2Vec2PretrainingConfig,
    extract_features: torch.Tensor, mask_time_indices: Optional[torch.Tensor], *,
    temperature=2.0, training: bool = False, generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
):
    """Per-group Gumbel-softmax codebook lookup: hard straight-through
    one-hots at `temperature` when training, argmax one-hots in eval.

    Returns ((B, L, codevector_dim) f32 codevectors, scalar perplexity,
    (B, L, G) int32 codeword ids).  In training the straight-through term
    `(hard + soft) - soft` leaves a <= 1 ulp residue on the one-hots.
    """
    b, l, _ = extract_features.shape
    g, v = config.num_codevector_groups, config.num_codevectors_per_group
    logits = dense(extract_features, params.weight_proj.kernel, params.weight_proj.bias)
    logits = logits.reshape(b * l, g, v).float()
    mask = None if mask_time_indices is None else mask_time_indices.reshape(-1)

    if training:
        if generator is None:
            raise ValueError("training quantization needs a generator for the Gumbel noise")
        rows = global_rows(mesh, b)
        if rows is None:
            noise = _gumbel_noise(generator, logits.shape, logits.device)
        else:  # this rank's rows of the global batch's draw
            start, total = rows
            noise = _gumbel_noise(generator, (total * l, g, v), logits.device,
                                  slice(start * l, (start + b) * l))
        y_soft = torch.softmax((logits + noise) / temperature, dim=-1)
        ids = y_soft.argmax(dim=-1)
        hard = torch.nn.functional.one_hot(ids, v).to(torch.float32)
        # straight-through: forward = hard one-hot, gradient = soft
        probs = hard + y_soft - y_soft.detach()
        perplexity = _perplexity(torch.softmax(logits, dim=-1), mask, mesh)
    else:
        ids = logits.argmax(dim=-1)
        probs = torch.nn.functional.one_hot(ids, v).to(torch.float32)
        perplexity = _perplexity(probs, mask, mesh)

    codebook = params.codevectors.reshape(g, v, -1).float()
    # (BL, G, V) x (G, V, d/G) -> (BL, G, d/G); groups concatenate on the feature axis
    quantized = torch.einsum("ngv,gvd->ngd", probs, codebook)
    return quantized.reshape(b, l, -1), perplexity, ids.reshape(b, l, g).to(torch.int32)


def wav2vec2_for_pretraining_forward(
    params: Wav2Vec2ForPreTraining, config: Wav2Vec2PretrainingConfig, batch: torch.Tensor,
    mask_time_indices: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, *,
    training: bool = False, generator: Optional[torch.Generator] = None,
    gumbel_temperature=2.0, compute_dtype: torch.dtype = torch.float32,
    return_code_ids: bool = False, remat: Union[bool, str] = False,
    mesh: Optional[Mesh] = None,
):
    """Masked-prediction forward (`transformers.Wav2Vec2ForPreTraining.forward`).

    Returns (projected_states (B, L, P), projected_quantized (B, L, P),
    perplexity), all f32, plus the (B, L, G) codeword ids when
    `return_code_ids`.  `mask_time_indices` is an input, so that the loss,
    the negative sampler and the forward see the same mask.  `remat` as
    `modeling.encoder_forward`'s; `mesh` as in the module docstring.
    """
    _check_training(training, generator)
    w = params.wav2vec2
    x = feature_encoder_forward(w.feature_extractor, config, batch, compute_dtype)
    fp = w.feature_projection
    # the normed conv features feed both the projection and the quantizer
    extract_features = layer_norm(x, fp.layer_norm.gamma, fp.layer_norm.beta, config.layer_norm_eps)
    h = dense(extract_features, fp.projection.kernel, fp.projection.bias)
    h = dropout(h, config.dropout, seed_words(generator) if training else None, not training,
                global_span(mesh, h.shape))

    mask_time_indices = mask_time_indices.to(h.device).bool()
    fill = w.masked_spec_embed.to(h.dtype)[None, None, :]
    h = torch.where(mask_time_indices[:, :, None], fill, h)

    frame_mask = None
    if attention_mask is not None:
        input_length = attention_mask.to(torch.int64).sum(dim=-1)
        frame_length = config.conv_output_length(input_length)
        frame_mask = torch.arange(h.shape[1], device=h.device)[None, :] < frame_length[:, None]

    hidden = encoder_forward(w.encoder, config, h, frame_mask, training=training,
                             generator=generator, remat=remat, mesh=mesh)
    projected_states = dense(hidden, params.project_hid.kernel, params.project_hid.bias).float()

    feats = dropout(extract_features, config.feat_quantizer_dropout,
                    seed_words(generator) if training else None, not training,
                    global_span(mesh, extract_features.shape))
    quantized, perplexity, code_ids = gumbel_vector_quantizer(
        params.quantizer, config, feats, mask_time_indices,
        temperature=gumbel_temperature, training=training, generator=generator, mesh=mesh,
    )
    projected_quantized = dense(quantized, params.project_q.kernel, params.project_q.bias).float()
    if return_code_ids:
        return projected_states, projected_quantized, perplexity, code_ids
    return projected_states, projected_quantized, perplexity


def _uniform_below(generator: torch.Generator, shape, high: torch.Tensor,
                   block: slice = slice(None)) -> torch.Tensor:
    """int64 draws of `shape`, uniform on [0, high) with `high` (B,) >= 1
    broadcast over the trailing axes; `block`: the leading-axis rows of the
    draw to keep (`high` is theirs)."""
    u = torch.rand(shape, generator=generator, device=generator.device)[block]
    high = high.to(u.device).reshape(-1, *([1] * (len(shape) - 1)))
    return torch.minimum((u * high).long(), high - 1)


def sample_negative_indices(
    generator: torch.Generator, mask_time_indices: torch.Tensor, num_negatives: int,
    rows=None,
) -> torch.Tensor:
    """K distractor indices per frame, drawn from the other masked frames of
    the same utterance (HF `_sample_negative_indices`).

    For masked frame i with rank r among its row's m masked frames: draw
    u ~ U{0, m-2}, shift u >= r up by one (uniform over the m-1 others), and
    map rank -> position through the cumulative mask count (`searchsorted`:
    position(r) = #{j : cum[j] <= r}).  Unmasked frames get in-row index 0;
    the loss never reads them.

    Returns (B, L, K) int32 indices into the flattened (B * L) frame axis, on
    the mask's device.  With `rows = (start, global_rows)` the uniforms are
    rows [start, start + B) of the global batch's draw (a data-parallel
    rank's share); the indices stay local to the B rows.
    """
    b, l = mask_time_indices.shape
    k = num_negatives
    mask = mask_time_indices.bool()
    dev = mask.device
    cum = torch.cumsum(mask.to(torch.int64), dim=1)  # (B, L)
    m = cum[:, -1]
    rank = cum - 1  # rank among masked, valid on masked positions
    high = (m - 1).clamp_min(1)
    if rows is None:
        u = _uniform_below(generator, (b, l, k), high).to(dev)
    else:  # this rank's rows of the global batch's uniforms
        start, total = rows
        u = _uniform_below(generator, (total, l, k), high, slice(start, start + b)).to(dev)
    shifted = u + (u >= rank[:, :, None]).to(torch.int64)
    shifted = torch.minimum(shifted.clamp_min(0), (m - 1).clamp_min(0)[:, None, None])
    neg_pos = torch.searchsorted(cum, shifted.reshape(b, l * k), right=True).reshape(b, l, k)
    neg_pos = torch.where(mask[:, :, None], neg_pos, torch.zeros_like(neg_pos))
    row_off = (torch.arange(b, device=dev) * l)[:, None, None]
    return (neg_pos + row_off).to(torch.int32)


class _GatherRows(torch.autograd.Function):
    """`q2d[flat_idx]` whose backward is the `scatter_rows_add` kernel on
    (B, L*K, D) cotangent rows and row-local indices (JAX `_gather_bwd`)."""

    @staticmethod
    def forward(ctx, q2d, flat_idx, b: int, l: int):
        ctx.save_for_backward(flat_idx)
        ctx.b, ctx.l = b, l
        return q2d[flat_idx]

    @staticmethod
    def backward(ctx, dneg):
        (flat_idx,) = ctx.saved_tensors
        b, l, d = ctx.b, ctx.l, dneg.shape[-1]
        local = flat_idx.reshape(b, -1) - (torch.arange(b, device=dneg.device) * l)[:, None]
        dq = scatter_add.scatter_rows_add(
            dneg.reshape(b, -1, d), local.to(torch.int32), l_rows=l)
        return dq.reshape(b * l, d).to(dneg.dtype), None, None, None


def pretraining_loss(
    projected_states: torch.Tensor, projected_quantized: torch.Tensor,
    perplexity: torch.Tensor, mask_time_indices: torch.Tensor,
    sampled_negative_indices: torch.Tensor, config: Wav2Vec2PretrainingConfig,
    code_ids: Optional[torch.Tensor] = None, scatter_kernel: Optional[bool] = None,
    contrastive_impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Contrastive + diversity objective (paper eq. 3-4; HF steps 3-8), all in
    f32; the contrastive loss is the SUM over masked frames.

    `contrastive_impl`:

    **"gram"**: per utterance the negative similarities are entries of the
    (L, L) Gram matrix pred @ q^T, picked out by a gather along the key
    axis (the JAX package selects the same entries by a compare-select-reduce
    over a (B, L, K, L) iota, which eager PyTorch would materialise); no
    (B, L, K, D) tensor.  The Gram product runs in f64: it feeds exp()
    through a 1 / temperature amplifier and must not depend on the
    process-wide TF32 switch.  Needs `code_ids`.

    **"gather"**: HF's flat-index row gather into (B, L, K, D), each norm
    computed once.  Without `code_ids` the `neg_is_pos` test compares the
    gathered vectors (HF-exact).

    "auto" is "gram" when `code_ids` is given and `scatter_kernel` is None,
    else "gather".

    `scatter_kernel` (JAX: `pallas_scatter`) routes the row gather's backward:
    None or True through `ops/kernels/scatter_add.py` (the CUDA kernel for
    CUDA tensors, raising where it does not support the shape; its plain
    version for CPU tensors), False through autograd's own `index` backward.
    """
    b, l, d = projected_quantized.shape
    k = sampled_negative_indices.shape[-1]
    pred = projected_states.float()
    q = projected_quantized.float()
    mask_time_indices = mask_time_indices.to(q.device)
    sampled_negative_indices = sampled_negative_indices.to(q.device)
    flat_idx = sampled_negative_indices.reshape(-1).long()

    if contrastive_impl == "auto":
        contrastive_impl = "gram" if code_ids is not None and scatter_kernel is None else "gather"
    if contrastive_impl not in ("gram", "gather"):
        raise ValueError(f"unknown contrastive_impl {contrastive_impl!r}")
    if contrastive_impl == "gram" and code_ids is None:
        raise ValueError(
            "contrastive_impl='gram' requires code_ids (neg_is_pos by codeword identity); "
            "pass code_ids or use 'gather'")

    # torch.cosine_similarity clamps each norm at eps=1e-8
    pred_norm = torch.linalg.vector_norm(pred, dim=-1).clamp_min(1e-8)  # (B, L)
    q_norm = torch.linalg.vector_norm(q, dim=-1).clamp_min(1e-8)
    inv_temp = 1.0 / config.contrastive_logits_temperature
    logit_pos = (pred * q).sum(dim=-1) / (pred_norm * q_norm) * inv_temp  # (B, L)

    negatives = None
    if contrastive_impl == "gram":
        logit_neg = _gram_negative_logits(
            pred, q, q_norm, pred_norm, sampled_negative_indices, inv_temp)
    else:
        q2d = q.reshape(b * l, d)
        if scatter_kernel is None or scatter_kernel:
            if q.is_cuda and not scatter_add.supports(l, d):
                raise ValueError(f"scatter_rows_add does not take {l} rows of width {d}")
            negatives = _GatherRows.apply(q2d, flat_idx, b, l)
        else:
            negatives = q2d[flat_idx]
        # (B, L, K, D): the row gather's native layout, K minor to D
        negatives = negatives.reshape(b, l, k, d)
        neg_norm = torch.linalg.vector_norm(negatives, dim=-1).clamp_min(1e-8)
        logit_neg = ((pred[:, :, None, :] * negatives).sum(dim=-1)
                     / (pred_norm[:, :, None] * neg_norm)) * inv_temp  # (B, L, K)

    # distractors that are the target cannot count as negatives
    if code_ids is not None:
        g = code_ids.shape[-1]
        ids_neg = code_ids.reshape(b * l, g)[flat_idx].reshape(b, l, k, g)
        neg_is_pos = (ids_neg == code_ids[:, :, None, :]).all(dim=-1)
    else:
        neg_is_pos = (q[:, :, None, :] == negatives).all(dim=-1)
    logit_neg = logit_neg.masked_fill(neg_is_pos, float("-inf"))
    return _loss_tail(logit_pos, logit_neg, mask_time_indices, perplexity, config)


class _TakeAlong(torch.autograd.Function):
    """`x.gather(-1, idx)` whose backward adds without float atomics, so that
    a step is bit-reproducible: `index_put_(accumulate=True)` on the card (a
    sort, then each destination summed in order) and `scatter_add_` on the
    CPU (serial along the gathered axis).  Autograd's own gather backward on
    the card is a `scatter_add_` with float atomics."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x.gather(-1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros(ctx.shape)
        if not g.is_cuda:
            return out.scatter_add_(-1, idx, g), None
        lead = torch.meshgrid(*(torch.arange(n, device=g.device) for n in idx.shape[:-1]),
                              indexing="ij")
        out.index_put_((*(a[..., None].expand_as(idx) for a in lead), idx), g, accumulate=True)
        return out, None


def _gram_negative_logits(pred, q, q_norm, pred_norm, sampled_negative_indices, inv_temp):
    """(B, L, K) negative cosine logits via the per-utterance Gram matrix:
    s[l, k] = G[l, idx[l, k]] with G = pred @ q^T, and the negatives' norms
    q_norm[idx[l, k]].  The two gathers' backward (`_TakeAlong`) adds into
    the dense (B, L, L) cotangent and into (B, L); d_pred and d_q are the
    Gram product's own backward."""
    b, l, _ = q.shape
    k = sampled_negative_indices.shape[-1]
    # negatives are drawn within one utterance, so the indices are row-local
    local = sampled_negative_indices.long() - (torch.arange(b, device=q.device) * l)[:, None, None]
    gram = (pred.double() @ q.double().transpose(1, 2)).float()  # (B, L, L)
    s = _TakeAlong.apply(gram, local)
    nn_ = _TakeAlong.apply(q_norm, local.reshape(b, l * k)).reshape(b, l, k).clamp_min(1e-8)
    return (s / (pred_norm[:, :, None] * nn_)) * inv_temp


def _loss_tail(logit_pos, logit_neg, mask_time_indices, perplexity, config):
    """Shared contrastive/diversity reduction (HF steps 7-8).  The positive
    joins the negatives in one logsumexp, so a row whose negatives are all
    -inf stays finite in the backward as well (log Z = the positive)."""
    mask = mask_time_indices.to(torch.float32)  # (B, L)
    log_z = torch.logsumexp(torch.cat([logit_pos[:, :, None], logit_neg], dim=-1), dim=-1)
    contrastive = ((log_z - logit_pos) * mask).sum()

    gv = float(config.num_codevectors)
    diversity = ((gv - perplexity) / gv) * mask.sum()
    loss = contrastive + config.diversity_loss_weight * diversity
    return {
        "loss": loss,
        "contrastive_loss": contrastive,
        "diversity_loss": diversity,
        "codevector_perplexity": perplexity,
    }


def ctc_params_from_pretraining(pretrain_model: Wav2Vec2ForPreTraining, config,
                                generator: torch.Generator) -> Wav2Vec2ForCTC:
    """Pretrained backbone -> a fine-tune-ready `Wav2Vec2ForCTC` on the same
    device: the backbone copied, the quantizer and projection heads dropped,
    the LM head fresh from `generator`."""
    model = Wav2Vec2ForCTC(config, device="cpu")
    model.lm_head = Dense(config.hidden_size, config.vocab_size, generator)
    model.wav2vec2.load_state_dict(
        {n: t.detach().cpu() for n, t in pretrain_model.wav2vec2.state_dict().items()})
    model.requires_grad_(False)
    return model.to(pretrain_model.device)


PART_NAMES = ("contrastive_loss", "diversity_loss", "codevector_perplexity")


def _global_parts(parts: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> dict:
    """The loss parts of the global batch: the sums over the data group
    (the perplexity is global already)."""
    return {k: (parts[k].detach() if k == "codevector_perplexity"
                else data_sum(parts[k].detach(), mesh)) for k in PART_NAMES}


def _make_pretrain_loss_fn(config: Wav2Vec2PretrainingConfig, *, division_factor: float,
                           with_attention_mask: bool, compute_dtype: Optional[torch.dtype],
                           remat: Union[bool, str] = False, mesh: Optional[Mesh] = None):
    """`(model, batch, generator, temperature) -> (scalar, parts)`: the
    objective summed over the batch / `division_factor`, and its undivided
    parts (this rank's, under a `mesh`).  Shared by the step and the
    accumulation steps."""

    def loss_fn(model, batch: dict, generator: torch.Generator, temperature):
        dev = model.device
        batch = _to_device(batch, dev)
        mask = batch.get("attention_mask") if with_attention_mask else None
        mti = batch["mask_time_indices"]
        states, quantized, perplexity, code_ids = wav2vec2_for_pretraining_forward(
            model, config, batch["speech"].float(), mti, mask, training=True,
            generator=generator, gumbel_temperature=temperature,
            compute_dtype=compute_dtype or default_compute_dtype(dev), return_code_ids=True,
            remat=remat, mesh=mesh,
        )
        negs = sample_negative_indices(generator, mti, config.num_negatives,
                                       rows=global_rows(mesh, mti.shape[0]))
        # auto resolves to the "gram" formulation (code_ids present)
        parts = pretraining_loss(states, quantized, perplexity, mti, negs, config,
                                 code_ids=code_ids)
        return parts["loss"] / division_factor, parts

    return loss_fn


def make_pretrain_step(config: Wav2Vec2PretrainingConfig, *, division_factor: float,
                       with_attention_mask: bool = False,
                       compute_dtype: Optional[torch.dtype] = None,
                       ema_decay: Optional[float] = None, remat: Union[bool, str] = True,
                       mesh: Optional[Mesh] = None):
    """`(state, batch, generator, gumbel_temperature) -> (state, metrics)`:
    one forward, backward and optimizer update, in place.

    `batch` needs "speech" (B, L) and "mask_time_indices" (B, L_frames) bool,
    plus optionally "attention_mask"; the negatives are drawn inside the
    step.  The metrics carry the undivided loss parts, the optimized
    (`division_factor`-normalised) "loss" and "grad_norm".  `remat` as
    `modeling.encoder_forward`'s (JAX's step functions default to True).
    Under a `mesh` each rank passes its rows, `division_factor` is the global
    batch, the gradients are summed over the data group and the metrics are
    the global ones."""
    loss_fn = _make_pretrain_loss_fn(config, division_factor=division_factor,
                                     with_attention_mask=with_attention_mask,
                                     compute_dtype=compute_dtype, remat=remat, mesh=mesh)

    def step(state: TrainState, batch: dict, generator: torch.Generator, temperature):
        state.optimizer.zero_grad(set_to_none=True)
        loss, parts = loss_fn(state.model, batch, generator, temperature)
        loss.backward()
        state, metrics = _apply(state, loss, ema_decay, mesh)
        return state, {**_global_parts(parts, mesh), **metrics}

    return step


def make_pretrain_accum_steps(config: Wav2Vec2PretrainingConfig, *, division_factor: float,
                              with_attention_mask: bool = False,
                              compute_dtype: Optional[torch.dtype] = None,
                              ema_decay: Optional[float] = None,
                              remat: Union[bool, str] = True, mesh: Optional[Mesh] = None):
    """Gradient accumulation, `(init_fn, accum_fn, apply_fn)`: the objective
    decomposes per utterance (negatives come from the same utterance), so
    microbatch gradients summed in `.grad` optimize it at the effective batch
    size `division_factor` names::

        metrics = init_fn(state)
        for batch in microbatches:
            metrics = accum_fn(state, batch, generator, temperature, metrics)
        state, metrics = apply_fn(state, metrics)

    `accum_fn` sums each microbatch's loss and parts, so
    "codevector_perplexity" comes back as a sum over microbatches.  `mesh`
    as in `make_pretrain_step`."""
    loss_fn = _make_pretrain_loss_fn(config, division_factor=division_factor,
                                     with_attention_mask=with_attention_mask,
                                     compute_dtype=compute_dtype, remat=remat, mesh=mesh)

    def init_fn(state: TrainState) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        return {k: torch.zeros((), dtype=torch.float32) for k in ("loss", *PART_NAMES)}

    def accum_fn(state: TrainState, batch: dict, generator: torch.Generator, temperature,
                 metrics_acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, parts = loss_fn(state.model, batch, generator, temperature)
        loss.backward()
        return {k: metrics_acc[k] + (loss if k == "loss" else parts[k]).detach().cpu()
                for k in metrics_acc}

    def apply_fn(state: TrainState, metrics_acc: Dict[str, torch.Tensor]):
        state, metrics = _apply(state, metrics_acc["loss"], ema_decay, mesh)
        return state, {**_global_parts(metrics_acc, mesh), **metrics}

    return init_fn, accum_fn, apply_fn

"""On-card tests of the port's CUDA kernels (marked `cuda`; they skip
without a device).  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import math

import pytest
import torch

from gsoc_wav2vec2_tpu_torch.models.config import Wav2Vec2Config
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC, wav2vec2_for_ctc_forward
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend, flash_attention, pos_conv, scatter_add

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_wrong_dtype(cuda):
    """A CUDA tensor of a dtype a kernel does not take raises; nothing falls
    back to the plain version."""
    x = torch.randn(2, 24000, device=cuda)
    w0, gb = torch.randn(10, 1, 512, device=cuda), torch.ones(512, device=cuda)
    with pytest.raises(ValueError):
        conv_frontend.groupnorm_stats(x, conv_frontend.conv0_length(24000), w0, gb, gb, 1e-5)
    xs = torch.randn(2, 64, 768, device=cuda)
    kernel = torch.randn(128, 48, 768, device=cuda)
    with pytest.raises(ValueError):
        pos_conv.pos_conv(xs, kernel, torch.zeros(768, device=cuda), groups=16, gelu_approx=True)
    # flash takes bf16 and f32 at 64-256: f32 at 320 and f16 raise
    q = torch.randn(2, 4, 64, 320, device=cuda)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, q)
    q = torch.randn(2, 4, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, q)
    # the kernels compute tanh GELU only; the erf form raises
    xb = xs.to(torch.bfloat16)
    with pytest.raises(ValueError, match="tanh GELU"):
        pos_conv.pos_conv(xb, kernel, torch.zeros(768, device=cuda), groups=16, gelu_approx=False)
    wave = torch.randn(2, 24000, device=cuda, dtype=torch.bfloat16)
    w0, w1 = torch.randn(10, 1, 512, device=cuda), torch.randn(3, 512, 512, device=cuda)
    ss = torch.ones(2, 512, device=cuda)
    with pytest.raises(ValueError, match="tanh GELU"):
        conv_frontend.conv01(wave, w0, ss, ss, w1, 100, False)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda):
    """Each kernel against its plain version at small shapes, in bf16."""
    g = torch.Generator().manual_seed(0)
    wave = torch.randn(2, 26003, generator=g).to(cuda)
    w0 = (torch.randn(10, 1, 512, generator=g) * 0.3).to(cuda)
    w1 = (torch.randn(3, 512, 512, generator=g) * 0.05).to(cuda)
    gamma = (1 + 0.1 * torch.randn(512, generator=g)).to(cuda)
    beta = (0.1 * torch.randn(512, generator=g)).to(cuda)
    x = wave.to(torch.bfloat16)
    t0 = conv_frontend.conv0_length(x.shape[1])
    scale, shift = conv_frontend.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
    pscale, pshift = conv_frontend.groupnorm_stats_plain(x, t0, w0, gamma, beta, 1e-5)
    # f32 sums in another order: 1e-5 of each output's scale
    for got, want in ((scale, pscale), (shift, pshift)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    t1 = 1 + (t0 - 3) // 2
    got = conv_frontend.conv01(x, w0, scale, shift, w1, t1, True).float()
    want = conv_frontend.conv01_plain(x, w0, scale, shift, w1, t1, True).float()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 0.05

    for t in (300, 3000):
        xs = torch.randn(2, t, 768, generator=g).to(cuda, torch.bfloat16)
        kernel = (torch.randn(128, 48, 768, generator=g) * 0.02).to(cuda)
        bias = (0.1 * torch.randn(768, generator=g)).to(cuda)
        got = pos_conv.pos_conv(xs, kernel, bias, groups=16, gelu_approx=True).float()
        want = pos_conv.pos_conv_plain(xs, kernel, bias, groups=16, gelu_approx=True).float()
        assert (got - want).abs().max().item() < 0.05

    for l in (200, 768):
        q, k, v = (torch.randn(2, 4, l, 64, generator=g).to(cuda, torch.bfloat16) for _ in range(3))
        q = q * 0.25
        bias = torch.zeros(2, l)
        bias[1, l // 2:] = -10000.0
        bias = bias.to(cuda)
        # the heads of (B, L, H, D) tensors, as split_heads gives them (strided)
        qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
        for b in (None, bias):
            pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, b)
            for args in ((q, k, v), (qs, ks, vs)):
                out, lse = flash_attention.flash_attention_fwd(*args, b)
                assert (out.float() - pout.float()).abs().max().item() < 0.02
                torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_small_model_goes_through_the_kernels(cuda):
    """A narrow base model on the card launches each kernel as the main path
    does (1 / 1 / 1 / one per layer) and tracks its f32 CPU copy."""
    cfg = Wav2Vec2Config(hidden_size=128, num_heads=2, num_layers=2, intermediate_size=256,
                         filter_sizes=[256] * 7, num_conv_pos_embedding_groups=8,
                         dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(cfg, device=cuda)
    x = torch.randn(2, 16000, generator=torch.Generator().manual_seed(1))
    kernels = (conv_frontend.groupnorm_stats, conv_frontend.conv01, pos_conv.pos_conv,
               flash_attention.flash_attention_fwd)
    for k in kernels:
        k.launches = 0
    with torch.inference_mode():
        logits = model(x.to(cuda))
        torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [1, 1, 1, cfg.num_layers]
    assert torch.isfinite(logits).all()
    cpu = model.to("cpu")
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(cpu, cfg, x)
    assert (logits.cpu() - ref).abs().max().item() < 0.1 * (1 + ref.abs().max().item())


ROBUST_SMALL = dict(hidden_size=256, num_heads=4, num_layers=2, intermediate_size=512,
                    filter_sizes=[256] * 7, num_conv_pos_embedding_groups=4,
                    dropout=0.0, apply_spec_augment=False)  # pos conv C/G = 64


def _robust_frontend_inputs(c, length, g, cuda, b=2):
    wave = torch.randn(b, length, generator=g).to(cuda, torch.bfloat16)
    w0 = (torch.randn(10, 1, c, generator=g) * 0.3).to(cuda)
    w1 = (torch.randn(3, c, c, generator=g) * 0.05).to(cuda)
    vecs = [(s * torch.randn(c, generator=g) + o).to(cuda)
            for s, o in ((0.1, 0.0), (0.1, 1.0), (0.1, 0.0), (0.1, 0.0), (0.1, 1.0), (0.1, 0.0))]
    b0, g0, e0, b1, g1, e1 = vecs
    return wave, (w0, b0, g0, e0, w1, b1, g1, e1)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [26003, 24000, 40975])
@pytest.mark.parametrize("c", conv_frontend.KERNEL_WIDTHS)
def test_conv01_robust_matches_plain_on_card(cuda, c, length):
    """The robust front end kernel against its plain version at every
    instance width: full tiles, a tail tile (T1 not a multiple of 64) and a
    waveform whose last conv0 window ends at the last sample."""
    g = torch.Generator().manual_seed(c + length)
    wave, params = _robust_frontend_inputs(c, length, g, cuda)
    t1 = conv_frontend.conv1_length(length)
    got = conv_frontend.conv01_robust(wave, *params, t1, 1e-5, True)
    want = conv_frontend.conv01_robust_plain(wave, *params, t1, 1e-5, True)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, t1, c) and got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    # bf16 outputs (ulp 2^-6 at |y| in [2, 4)) over f32 sums in another order
    assert d.max().item() < 0.05 and d.mean().item() < 5e-3
    with pytest.raises(ValueError, match="tanh GELU"):
        conv_frontend.conv01_robust(wave, *params, t1, 1e-5, False)
    with pytest.raises(ValueError):
        conv_frontend.conv01_robust(wave.float(), *params, t1, 1e-5, True)


@pytest.mark.cuda
def test_robust_family_runs_on_card(cuda):
    """A narrow robust model (LayerNorm front end, pre-norm layers, pos conv
    at C/G = 64) on the card with a ragged mask launches its kernels (no
    statistics pass) and tracks its f32 CPU copy."""
    from gsoc_wav2vec2_tpu_torch.models.config import RobustWav2Vec2Config

    cfg = RobustWav2Vec2Config(**ROBUST_SMALL)
    model = Wav2Vec2ForCTC(cfg, device=cuda)
    x = torch.randn(2, 16000, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 16000, dtype=torch.int64)
    mask[1, 9000:] = 0
    x[1, 9000:] = 0.0
    kernels = (conv_frontend.groupnorm_stats, conv_frontend.conv01, conv_frontend.conv01_robust,
               pos_conv.pos_conv, flash_attention.flash_attention_fwd)
    for k in kernels:
        k.launches = 0
    with torch.inference_mode():
        logits = model(x.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [0, 0, 1, 1, cfg.num_layers]
    assert torch.isfinite(logits).all()
    cpu = model.to("cpu")
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(cpu, cfg, x, mask)
    assert (logits.cpu() - ref).abs().max().item() < 0.1 * (1 + ref.abs().max().item())


def _robust_steps_go_through_the_kernels(cuda, **overrides):
    """Six stage-2 steps (mask, length-aware CTC) of the narrow robust model:
    each launches each kernel once per site, and the loss goes down."""
    from gsoc_wav2vec2_tpu_torch.models.config import RobustWav2Vec2Config
    from gsoc_wav2vec2_tpu_torch.training import (
        create_optimizer, create_train_state, make_train_step, set_trainable)

    cfg = RobustWav2Vec2Config(**{**ROBUST_SMALL, **overrides})
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    labels = torch.randint(1, cfg.vocab_size, (2, 12), generator=g)
    labels[1, 8:] = 0
    mask = torch.ones(2, 32000, dtype=torch.int64)
    mask[1, 25000:] = 0
    batch = {"speech": torch.randn(2, 32000, generator=g) * mask, "labels": labels,
             "attention_mask": mask}
    set_trainable(model, ("feature_extractor",))
    state = create_train_state(model, create_optimizer(model, 1e-3))
    step = make_train_step(cfg, division_factor=2, with_attention_mask=True, length_aware=True)
    kernels = {"conv01_robust": conv_frontend.conv01_robust, "groupnorm_stats": conv_frontend.groupnorm_stats,
               "pos_conv_train_fwd": pos_conv.pos_conv_train_fwd,
               "pos_conv_dx": pos_conv.pos_conv_dx, "pos_conv_dw": pos_conv.pos_conv_dw,
               "flash_attention_fwd": flash_attention.flash_attention_fwd,
               "flash_attention_bwd": flash_attention.flash_attention_bwd}
    losses = []
    for i in range(6):
        for fn in kernels.values():
            fn.launches = 0
        state, metrics = step(state, batch, torch.Generator().manual_seed(i))
        losses.append(metrics["loss"].item())
        # the step's default remat runs each layer's attention forward again
        # in the backward: 2 layers, 4 forwards
        assert {k: fn.launches for k, fn in kernels.items()} == {
            "conv01_robust": 1, "groupnorm_stats": 0, "pos_conv_train_fwd": 1, "pos_conv_dx": 1,
            "pos_conv_dw": 1, "flash_attention_fwd": 4, "flash_attention_bwd": 2}
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]


@pytest.mark.cuda
def test_small_robust_train_step_goes_through_the_kernels(cuda):
    """The narrow robust model's stage-2 step launches each kernel once per
    site and its loss goes down."""
    _robust_steps_go_through_the_kernels(cuda)


@pytest.mark.cuda
def test_robust_step_at_36_pos_conv_taps_goes_through_the_kernels(cuda):
    """36 taps at 64 channels a group: `pos_conv.supports` admits it (the dW
    kernel takes 4 taps a block there), so the step takes `PosConvTrain`,
    and every pos-conv wrapper, the dW one included, launches its kernel."""
    assert pos_conv.supports(ROBUST_SMALL["hidden_size"], ROBUST_SMALL["num_conv_pos_embedding_groups"],
                             torch.bfloat16, 36)
    _robust_steps_go_through_the_kernels(cuda, num_conv_pos_embeddings=36)


@pytest.mark.cuda
def test_robust_step_at_head_dim_128_goes_through_the_kernels(cuda):
    """Two heads of 128: `flash_attention.supports` takes them, so the step's
    attention launches the flash kernels' D = 128 instances, forward and
    backward, and the loss goes down."""
    assert flash_attention.supports(ROBUST_SMALL["hidden_size"] // 2, torch.bfloat16)
    _robust_steps_go_through_the_kernels(cuda, num_heads=2)


@pytest.mark.cuda
def test_robust_step_at_head_dim_256_goes_through_the_kernels(cuda):
    """One head of 256: `flash_attention.supports` takes it, so the step's
    attention launches the flash kernels' D = 256 instances, forward and
    backward, and the loss goes down."""
    assert flash_attention.supports(ROBUST_SMALL["hidden_size"], torch.bfloat16)
    _robust_steps_go_through_the_kernels(cuda, num_heads=1)


# the head dims of the flash kernels' instances
FLASH_HEAD_DIMS = (64, 128, 192, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("l,b,h", [(5999, 1, 2), (8192, 1, 2)])
def test_flash_long_sequences_match_plain_on_card(cuda, l, b, h, d):
    """Past 4096 frames (where the TPU package switches to its kv-blocked
    kernels): forward and backward with dropout 0.1 and a ragged key bias
    against the plain versions; L = 5999 hashes with the padded stride 6016."""
    g = torch.Generator().manual_seed(l)
    q, k, v, dout = _peaky_qkv(b, h, l, g, cuda, d)
    bias = torch.zeros(b, l)
    bias[0, (2 * l) // 3:] = -10000.0
    bias = bias.to(cuda)
    out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, dropout_rate=0.1, seed=7)
    pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=0.1, seed=7)
    assert (out.float() - pout.float()).abs().max().item() < 0.04
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-3)
    grads = flash_attention.flash_attention_bwd(q, k, v, bias, pout, plse, dout,
                                                dropout_rate=0.1, seed=7)
    pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, bias, pout, plse, dout,
                                                       dropout_rate=0.1, seed=7)
    for got, want in zip(grads, pgrads):
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() < 0.01 * scale


def _peaky_qkv(b, h, l, g, cuda, d=64):
    """bf16 q, k, v, dout (B, H, L, d) with scores of std ~6: most rows have
    one dominant key, so a keep bit that differs moves that row by ~|v|."""
    q, k, v, dout = (torch.randn(b, h, l, d, generator=g).to(cuda, torch.bfloat16)
                     for _ in range(4))
    return q * (6.0 / d ** 0.5), k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("l", [200, 768])
def test_flash_dropout_fwd_bwd_match_plain_on_card(cuda, l, d):
    """The kernels' dropout against the plain versions, same seed, ragged
    bias, forward and backward.  The tolerances are far below what one
    differing keep bit moves; a plain run with another seed shows it."""
    g = torch.Generator().manual_seed(l)
    q, k, v, dout = _peaky_qkv(2, 4, l, g, cuda, d)
    bias = torch.zeros(2, l)
    bias[1, l // 3:] = -10000.0
    bias = bias.to(cuda)
    for rate in (0.0, 0.1):
        out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, dropout_rate=rate, seed=99)
        pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=rate,
                                                               seed=99)
        assert (out.float() - pout.float()).abs().max().item() < 0.04
        torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-3)
        grads = flash_attention.flash_attention_bwd(q, k, v, bias, pout, plse, dout,
                                                    dropout_rate=rate, seed=99)
        pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, bias, pout, plse, dout,
                                                           dropout_rate=rate, seed=99)
        for got, want in zip(grads, pgrads):
            scale = want.float().abs().max().item()
            assert (got.float() - want.float()).abs().max().item() < 0.01 * scale
    other, _ = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=0.1, seed=100)
    assert (other.float() - pout.float()).abs().max().item() > 0.4


@pytest.mark.cuda
@pytest.mark.parametrize("c", [768, 256, 1024, 1280])
def test_pos_conv_train_kernels_match_plain_on_card(cuda, c):
    """Inference forward, training forward (output and f32 pre-activation),
    dx and dW against their plain versions, C/G = 48, 16, 64 and 80, a
    ragged T."""
    g = torch.Generator().manual_seed(c)
    t, groups = 300, 16
    x, dpre = (torch.randn(2, t, c, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    kernel = (torch.randn(128, c // groups, c, generator=g) * 0.02).to(cuda)
    bias = (0.1 * torch.randn(c, generator=g)).to(cuda)
    y, pre = pos_conv.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True)
    py, ppre = pos_conv.pos_conv_train_fwd_plain(x, kernel, bias, groups=groups, gelu_approx=True)
    assert (y.float() - py.float()).abs().max().item() < 0.05
    ye = pos_conv.pos_conv(x, kernel, bias, groups=groups, gelu_approx=True)
    assert (ye.float() - py.float()).abs().max().item() < 0.05
    torch.testing.assert_close(pre, ppre, rtol=0, atol=1e-4 * ppre.abs().max().item())
    dx = pos_conv.pos_conv_dx(dpre, kernel, groups=groups).float()
    pdx = pos_conv.pos_conv_dx_plain(dpre, kernel, groups=groups).float()
    assert (dx - pdx).abs().max().item() < 0.015 * pdx.abs().max().item()
    dw = pos_conv.pos_conv_dw(x, dpre, 128, groups=groups)
    pdw = pos_conv.pos_conv_dw_plain(x, dpre, 128, groups=groups)
    torch.testing.assert_close(dw, pdw, rtol=0, atol=1e-4 * pdw.abs().max().item())


# C at 16 groups for each C/G instance
POS_CONV_C = {48: 768, 64: 1024, 16: 256, 80: 1280, 120: 1920, 32: 512, 96: 1536, 112: 1792,
              128: 2048, 8: 128, 24: 384, 40: 640, 56: 896, 72: 1152, 88: 1408, 104: 1664}


def _pos_conv_case(cuda, cg, k, b, t, seed):
    """bf16 x, dpre, f32 kernel and bias of one pos-conv shape on the card."""
    c = POS_CONV_C[cg]
    g = torch.Generator().manual_seed(seed)
    x, dpre = (torch.randn(b, t, c, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    kernel = (torch.randn(k, cg, c, generator=g) * (1.5 / (k * cg) ** 0.5)).to(cuda)
    bias = (0.1 * torch.randn(c, generator=g)).to(cuda)
    return x, dpre, kernel, bias, c // cg


def _check_pos_conv_wrappers(cuda, cg, k, b, t, seed=0):
    """The four pos-conv wrappers against their plain versions: bf16 outputs
    within 0.05 (mean 5e-3), dx within 1.5% of its scale, the f32
    pre-activation and dW within 1e-4 of their scales."""
    x, dpre, kernel, bias, groups = _pos_conv_case(cuda, cg, k, b, t, seed)
    y, pre = pos_conv.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True)
    py, ppre = pos_conv.pos_conv_train_fwd_plain(x, kernel, bias, groups=groups, gelu_approx=True)
    ye = pos_conv.pos_conv(x, kernel, bias, groups=groups, gelu_approx=True)
    for got in (y, ye):
        d = (got.float() - py.float()).abs()
        assert d.max().item() <= 0.05 and d.mean().item() <= 5e-3
    torch.testing.assert_close(pre, ppre, rtol=0, atol=1e-4 * ppre.abs().max().item())
    dx = pos_conv.pos_conv_dx(dpre, kernel, groups=groups).float()
    pdx = pos_conv.pos_conv_dx_plain(dpre, kernel, groups=groups).float()
    assert (dx - pdx).abs().max().item() <= 0.015 * pdx.abs().max().item()
    dw = pos_conv.pos_conv_dw(x, dpre, k, groups=groups)
    pdw = pos_conv.pos_conv_dw_plain(x, dpre, k, groups=groups)
    torch.testing.assert_close(dw, pdw, rtol=0, atol=1e-4 * pdw.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("cg", list(POS_CONV_C))
@pytest.mark.parametrize("b,t", [(b, t) for t in (1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 768)
                                 for b in (1, 3)] + [(1, 5999), (2, 3000)])
def test_pos_conv_kernels_match_plain_at_tile_edges(cuda, cg, b, t):
    """Every pos-conv wrapper at T on each side of the forward's 256-row and
    the dW kernel's 64-step tiles, one and three batch rows (ragged splits
    of the dW time tiles), the long path's 5999 frames and the 2 x 3000 of
    the smoke script's checks.  At 80 and 120 channels a group this holds
    the forward's B across a tap's two weight boxes, dx's k steps in both,
    and dW's unswizzled x window; so at 96, 112 and 128, where dW also
    splits a group's output channels over two CTAs (and pads a tap's rows
    to 128 at 112).  At the odd multiples of 8 (8 .. 104) the contraction
    is padded to whole k steps with zeros in both operands, and dW's N
    spans two dpre boxes at 72, 88 and 104."""
    _check_pos_conv_wrappers(cuda, cg, 128, b, t, seed=t + 7 * b)


@pytest.mark.cuda
@pytest.mark.parametrize("cg,k", [(64, 36), (64, 4), (48, 8), (48, 24), (16, 8), (16, 40),
                                  (80, 8), (80, 24), (120, 4), (120, 8), (120, 24), (120, 132),
                                  (32, 4), (32, 36), (96, 4), (96, 36), (112, 4), (112, 36),
                                  (112, 264), (128, 4), (128, 16), (128, 36), (128, 132),
                                  (8, 8), (8, 24), (24, 4), (24, 36), (40, 8), (40, 24), (56, 4),
                                  (56, 36), (72, 8), (72, 24), (88, 4), (88, 36), (104, 4),
                                  (104, 36), (104, 264)])
def test_pos_conv_kernels_match_plain_at_small_tap_counts(cuda, cg, k):
    """36 taps at 64 channels a group, the smallest tap count each instance
    takes, counts that end inside a dW CTA's tap block, and at 112, 120 and
    128 channels a group the most taps the forward's shared memory holds."""
    assert pos_conv.supports(POS_CONV_C[cg], 16, torch.bfloat16, k)
    _check_pos_conv_wrappers(cuda, cg, k, 3, 129, seed=k)


@pytest.mark.cuda
@pytest.mark.parametrize("cg,k,b,t", [(48, 128, 2, 300), (64, 36, 3, 129), (16, 128, 2, 300),
                                     (80, 128, 2, 300), (80, 8, 3, 129), (120, 128, 2, 300),
                                     (120, 4, 3, 129), (32, 128, 2, 300), (96, 128, 2, 300),
                                     (96, 8, 3, 129), (112, 128, 2, 300), (112, 4, 3, 129),
                                     (128, 128, 2, 300), (128, 4, 3, 129), (8, 128, 2, 300),
                                     (8, 8, 3, 129), (24, 128, 2, 300), (40, 8, 3, 129),
                                     (56, 128, 2, 300), (72, 128, 2, 300), (72, 8, 3, 129),
                                     (88, 128, 2, 300), (88, 4, 3, 129), (104, 128, 2, 300),
                                     (104, 4, 3, 129)])
def test_pos_conv_launches_are_bit_equal_on_card(cuda, cg, k, b, t):
    """Two launches of each pos-conv wrapper on the same inputs are
    bit-equal, a dW that splits its time tiles (C/G = 16: 64 tile blocks;
    C/G = 80 at 8 taps: 32 CTAs, two a tap block; C/G = 120 at 4 taps: 48
    CTAs, three a tap block, 2 splits; the odd multiples of 8 at their
    smallest tap counts: 8 splits at 8 and 88, 4 at 72 and 104)
    included."""
    x, dpre, kernel, bias, groups = _pos_conv_case(cuda, cg, k, b, t, 5)
    runs = [(pos_conv.pos_conv(x, kernel, bias, groups=groups, gelu_approx=True),
             *pos_conv.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True),
             pos_conv.pos_conv_dx(dpre, kernel, groups=groups),
             pos_conv.pos_conv_dw(x, dpre, k, groups=groups)) for _ in range(2)]
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_train_kernel_wrappers_raise_on_wrong_dtype(cuda):
    x = torch.randn(2, 64, 768, device=cuda)
    kernel = torch.randn(128, 48, 768, device=cuda)
    bias = torch.zeros(768, device=cuda)
    with pytest.raises(ValueError):
        pos_conv.pos_conv_train_fwd(x, kernel, bias, groups=16, gelu_approx=True)
    with pytest.raises(ValueError):
        pos_conv.pos_conv_dx(x, kernel, groups=16)
    with pytest.raises(ValueError):
        pos_conv.pos_conv_dw(x, x, 128, groups=16)
    # flash's backward takes bf16 and f32 at 64-256: f32 at 320 raises, and
    # so do out / dout in another dtype than q's
    q = torch.randn(2, 4, 64, 320, device=cuda)
    lse = torch.zeros(2, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd(q, q, q, None, q, lse, q)
    q = torch.randn(2, 4, 64, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd(q, q, q, None, q.bfloat16(), lse, q)


@pytest.mark.cuda
def test_small_model_train_step_goes_through_the_kernels(cuda):
    """A narrow base model's stage-2 step launches each kernel once per
    site (the attention ones once per layer), and its loss goes down over
    a few steps on one fixed batch."""
    from gsoc_wav2vec2_tpu_torch.training import (
        create_optimizer, create_train_state, make_train_step, set_trainable)

    cfg = Wav2Vec2Config(hidden_size=128, num_heads=2, num_layers=2, intermediate_size=256,
                         filter_sizes=[256] * 7, num_conv_pos_embedding_groups=8,
                         dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    labels = torch.randint(1, cfg.vocab_size, (2, 12), generator=g)
    labels[1, 8:] = 0
    batch = {"speech": torch.randn(2, 32000, generator=g), "labels": labels}
    set_trainable(model, ("feature_extractor",))
    state = create_train_state(model, create_optimizer(model, 1e-3))
    step = make_train_step(cfg, division_factor=2)
    kernels = {"groupnorm_stats": conv_frontend.groupnorm_stats, "conv01": conv_frontend.conv01,
               "pos_conv": pos_conv.pos_conv, "pos_conv_train_fwd": pos_conv.pos_conv_train_fwd,
               "pos_conv_dx": pos_conv.pos_conv_dx, "pos_conv_dw": pos_conv.pos_conv_dw,
               "flash_attention_fwd": flash_attention.flash_attention_fwd,
               "flash_attention_bwd": flash_attention.flash_attention_bwd}
    losses = []
    for i in range(6):
        for fn in kernels.values():
            fn.launches = 0
        state, metrics = step(state, batch, torch.Generator().manual_seed(i))
        losses.append(metrics["loss"].item())
        # the step's default remat runs each layer's attention forward again
        # in the backward: 2 layers, 4 forwards
        assert {k: fn.launches for k, fn in kernels.items()} == {
            "groupnorm_stats": 1, "conv01": 1, "pos_conv": 0, "pos_conv_train_fwd": 1,
            "pos_conv_dx": 1, "pos_conv_dw": 1, "flash_attention_fwd": 4,
            "flash_attention_bwd": 2}
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("robust", [False, True])
def test_trainable_front_end_trains_on_card(cuda, robust):
    """With conv0/conv1 trainable the front end runs as plain convolutions
    (the fused kernels have no backward and are not launched): the step's
    loss is finite and the conv0/conv1 gradients follow the f32 CPU copy's."""
    from gsoc_wav2vec2_tpu_torch.models.config import RobustWav2Vec2Config
    from gsoc_wav2vec2_tpu_torch.training import make_ctc_loss_fn, set_trainable

    if robust:
        cfg = RobustWav2Vec2Config(**ROBUST_SMALL)
    else:
        cfg = Wav2Vec2Config(hidden_size=128, num_heads=2, num_layers=1, intermediate_size=256,
                             filter_sizes=[256] * 7, num_conv_pos_embedding_groups=8,
                             dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    set_trainable(model, ())
    g = torch.Generator().manual_seed(1)
    batch = {"speech": torch.randn(2, 16000, generator=g),
             "labels": torch.randint(1, cfg.vocab_size, (2, 6), generator=g)}
    loss_fn = make_ctc_loss_fn(cfg, division_factor=2)
    fused = (conv_frontend.groupnorm_stats, conv_frontend.conv01, conv_frontend.conv01_robust)

    def run():
        for fn in fused:
            fn.launches = 0
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, torch.Generator().manual_seed(0))
        loss.backward()
        layers = model.wav2vec2.feature_extractor.conv_layers
        return loss.item(), [layers[i].conv.kernel.grad.detach().double().cpu().flatten()
                             for i in (0, 1)]

    card_loss, card_grads = run()
    assert [fn.launches for fn in fused] == [0, 0, 0]
    # frozen again, the same forward takes the fused kernel
    set_trainable(model, ("feature_extractor",))
    loss_fn(model, batch, torch.Generator().manual_seed(0))
    assert sum(fn.launches for fn in fused) == (1 if robust else 2)
    set_trainable(model, ())
    model.to("cpu")
    cpu_loss, cpu_grads = run()
    # bf16 on the card against f32 on the CPU through a 1-2 layer model
    assert abs(card_loss - cpu_loss) <= 0.02 * abs(cpu_loss)
    for got, want in zip(card_grads, cpu_grads):
        assert torch.isfinite(got).all() and got.abs().sum() > 0
        assert (got @ want / (got.norm() * want.norm())).item() >= 0.99


def _skewed_indices(b, n, l_rows, g, hot=0.6):
    """(B, N) int32 rows: a share `hot` of the sources in runs on row 0 (as
    the negative sampler gives unmasked frames), the rest uniform; row 1 of
    the batch scatters everything onto one row."""
    idx = torch.randint(0, l_rows, (b, n), generator=g)
    runs = torch.rand(b, -(-n // 10), generator=g) < hot
    idx[runs.repeat_interleave(10, dim=1)[:, :n]] = 0
    if b > 1:
        idx[1] = min(7, l_rows - 1)
    return idx.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,l_rows", [(1000, 128, 64), (9000, 256, 768), (5000, 768, 200),
                                         (300, 40, 24), (700, 37, 50), (4500, 256, 1536),
                                         (3000, 64, 2000)])
def test_scatter_rows_add_matches_plain_on_card(cuda, n, d, l_rows, dtype):
    """The scatter kernel against its plain version: N not a multiple of
    anything, a hot row, a width that is not a multiple of 32 and one whose
    rows are no multiple of 16 bytes (a padded copy), twice the recipe's
    rows, rows past the plan's shared-memory histograms; two launches are
    bit-equal."""
    g = torch.Generator().manual_seed(n + d)
    dneg = torch.randn(3, n, d, generator=g).to(cuda, dtype)
    idx = _skewed_indices(3, n, l_rows, g).to(cuda)
    scatter_add.scatter_rows_add.launches = 0
    got = scatter_add.scatter_rows_add(dneg, idx, l_rows=l_rows)
    again = scatter_add.scatter_rows_add(dneg, idx, l_rows=l_rows)
    want = scatter_add.scatter_rows_add_plain(dneg, idx, l_rows=l_rows)
    exact = torch.zeros(3 * l_rows, d, dtype=torch.float64, device=cuda).index_add_(
        0, (idx.long() + torch.arange(3, device=cuda)[:, None] * l_rows).flatten(),
        dneg.double().reshape(-1, d)).reshape(3, l_rows, d)
    torch.cuda.synchronize()
    assert scatter_add.scatter_rows_add.launches == 2
    assert got.shape == (3, l_rows, d) and got.dtype == torch.float32
    assert torch.equal(got, again)
    # f32 sums of up to N addends of unit scale in another order
    tol = 1e-5 * max(1.0, exact.abs().max().item())
    assert (got.double() - exact).abs().max().item() <= tol
    assert (got - want).abs().max().item() <= 2 * tol


def _sampler_indices(b, l, k, g):
    """(B, L K) int32 row-local indices from the port's negative sampler over
    a ragged span mask: every unmasked frame sends its K copies to row 0."""
    from gsoc_wav2vec2_tpu_torch.models import pretraining

    lengths = torch.randint(l // 3, l + 1, (b,), generator=g)
    lengths[0] = l
    mti = (torch.rand(b, l, generator=g) < 0.5) & (torch.arange(l)[None, :] < lengths[:, None])
    negs = pretraining.sample_negative_indices(g, mti, k)
    return (negs - (torch.arange(b) * l)[:, None, None].to(torch.int32)).reshape(b, l * k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 768])
@pytest.mark.parametrize("kind", ["sampler", "uniform", "one_row"])
def test_scatter_rows_add_main_shapes_on_card(cuda, kind, d, dtype):
    """The sort + balanced sum at the recipe's row count (768 frames x 100
    negatives, B=4): the sampler's skewed indices, uniform ones, and every
    source on one row; within 2e-5 of the plain version's output scale and
    1e-5 of the f64 sum, bit-equal on relaunch, rows without a source zero."""
    b, l, k = 4, 768, 100
    g = torch.Generator().manual_seed(d + len(kind))
    if kind == "sampler":
        idx = _sampler_indices(b, l, k, g)
        assert (idx == 0).float().mean().item() >= 0.3
    elif kind == "uniform":
        idx = torch.randint(0, l, (b, l * k), generator=g, dtype=torch.int32)
    else:
        idx = torch.full((b, l * k), 5, dtype=torch.int32)
    dneg = torch.randn(b, l * k, d, generator=g).to(cuda, dtype)
    idx = idx.to(cuda)
    got = scatter_add.scatter_rows_add(dneg, idx, l_rows=l)
    again = scatter_add.scatter_rows_add(dneg, idx, l_rows=l)
    want = scatter_add.scatter_rows_add_plain(dneg, idx, l_rows=l)
    exact = torch.zeros(b * l, d, dtype=torch.float64, device=cuda).index_add_(
        0, (idx.long() + torch.arange(b, device=cuda)[:, None] * l).flatten(),
        dneg.double().reshape(-1, d)).reshape(b, l, d)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = exact.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale
    empty = torch.ones(b, l, dtype=torch.bool, device=cuda)
    empty.scatter_(1, idx.long(), False)
    assert kind == "uniform" or empty.any()
    assert not got[empty].any()


@pytest.mark.cuda
def test_scatter_rows_add_raises_and_drops_on_card(cuda):
    dneg = torch.randn(2, 50, 64, device=cuda)
    idx = torch.zeros(2, 50, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        scatter_add.scatter_rows_add(dneg.half(), idx, l_rows=8)
    with pytest.raises(ValueError):
        scatter_add.scatter_rows_add(dneg, idx.long(), l_rows=8)
    with pytest.raises(ValueError):
        scatter_add.scatter_rows_add(dneg, idx[:, :40], l_rows=8)
    # an index outside [0, l_rows) is dropped, never written out of bounds
    idx[0, :10] = 8
    idx[1, :10] = -1
    got = scatter_add.scatter_rows_add(dneg, idx, l_rows=8)
    want = dneg[:, 10:].sum(dim=1)
    torch.testing.assert_close(got[:, 0], want, rtol=1e-5, atol=1e-5)
    assert not got[:, 1:].any()


@pytest.mark.cuda
def test_gather_rows_backward_matches_autograd_on_card(cuda):
    """`pretraining_loss`'s gather path through the scatter kernel against the
    same loss through autograd's own index backward, and against `gram`."""
    from gsoc_wav2vec2_tpu_torch.models import pretraining
    from gsoc_wav2vec2_tpu_torch.models.config import Wav2Vec2PretrainingConfig

    cfg = Wav2Vec2PretrainingConfig(num_negatives=20)
    b, l, d = 3, 96, cfg.proj_codevector_dim
    g = torch.Generator().manual_seed(5)
    states, quantized = (torch.randn(b, l, d, generator=g).to(cuda) for _ in range(2))
    mti = (torch.rand(b, l, generator=g) < 0.5).to(cuda)
    code_ids = torch.randint(0, 4, (b, l, 2), generator=g).to(cuda, torch.int32)
    negs = pretraining.sample_negative_indices(g, mti, cfg.num_negatives)
    perp = torch.tensor(5.0, device=cuda)

    def grads(impl, kernel):
        s, q = states.clone().requires_grad_(), quantized.clone().requires_grad_()
        loss = pretraining.pretraining_loss(s, q, perp, mti, negs, cfg, code_ids=code_ids,
                                            scatter_kernel=kernel, contrastive_impl=impl)["loss"]
        loss.backward()
        return loss.item(), s.grad, q.grad

    scatter_add.scatter_rows_add.launches = 0
    kern = grads("gather", True)
    assert scatter_add.scatter_rows_add.launches == 1
    auto = grads("gather", False)
    gram = grads("gram", None)
    assert scatter_add.scatter_rows_add.launches == 1
    assert kern[0] == auto[0]
    assert abs(gram[0] - auto[0]) <= 1e-5 * abs(auto[0])
    for got, other, want in zip(kern[1:], gram[1:], auto[1:]):
        scale = want.abs().max().item()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-5 * scale
        assert (other - want).abs().max().item() <= 1e-3 * scale


def _proj_view(x):
    """(B, H, L, D) -> the same values as the head split of a (B, L, H*D)
    projection: a strided view with the heads of a row side by side."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d).view(b, l, h, d).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("l", [1, 63, 64, 65, 127, 128, 129, 768, 1249])
def test_flash_tiles_and_edges_match_plain_on_card(cuda, l, d):
    """The wgmma/TMA kernels against the plain versions at every edge of their
    tiles (64-row boxes, 64-, 128- or 192-row blocks, 64- or 128-key forward
    tiles, d / 64 64-column boxes a row): no bias and a ragged bias, dropout 0
    and 0.1 (keep bits from `dropout_mask` in the plain path: one differing
    bit would move a row of these peaky scores far past the tolerance),
    q/k/v contiguous and as projection head views."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention import _strided_ok

    g = torch.Generator().manual_seed(1000 + l)
    q, k, v, dout = _peaky_qkv(2, 3, l, g, cuda, d)
    ragged = torch.zeros(2, l)
    ragged[1, max(1, (2 * l) // 3):] = -10000.0
    ragged = ragged.to(cuda)
    views = (q, k, v), tuple(_proj_view(x) for x in (q, k, v))
    assert _strided_ok(views[1][0]) and (l == 1 or not views[1][0].is_contiguous())
    for bias in (None, ragged):
        for rate in (0.0, 0.1):
            pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=rate, seed=5)
            pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, bias, pout, plse, dout,
                                                               dropout_rate=rate, seed=5)
            for qq, kk, vv in views:
                out, lse = flash_attention.flash_attention_fwd(qq, kk, vv, bias, dropout_rate=rate, seed=5)
                # bf16 outputs of these peaky rows reach |v| ~ 5 (ulp 0.03); p is
                # rounded before the normalisation here, after it in the plain path
                d = (out.float() - pout.float()).abs()
                assert d.max().item() < 0.04 and d.mean().item() < 2e-3, (bias is None, rate, d.max(), d.mean())
                torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-3)
                dd = dout if qq is q else _proj_view(dout)
                grads = flash_attention.flash_attention_bwd(qq, kk, vv, bias, pout, plse, dd,
                                                            dropout_rate=rate, seed=5)
                for got, want in zip(grads, pgrads):
                    scale = want.float().abs().max().item()
                    err = (got.float() - want.float()).abs().max().item()
                    # at L = 1, dq = dk = 0 up to rounding (ds = dp - delta = 0)
                    assert err <= 0.01 * scale + 1e-4, (bias is None, rate, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
def test_flash_launches_are_deterministic_on_card(cuda, d):
    """No float atomics: two launches of the forward and of the backward give
    equal bits (dropout, ragged bias, a ragged last tile)."""
    g = torch.Generator().manual_seed(11)
    q, k, v, dout = _peaky_qkv(2, 4, 1000, g, cuda, d)
    bias = torch.zeros(2, 1000)
    bias[0, 700:] = -10000.0
    bias = bias.to(cuda)
    runs = []
    for _ in range(2):
        out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, dropout_rate=0.1, seed=3)
        grads = flash_attention.flash_attention_bwd(q, k, v, bias, out, lse, dout,
                                                    dropout_rate=0.1, seed=3)
        runs.append((out, lse) + tuple(grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
def test_flash_misaligned_views_are_copied_on_card(cuda, d):
    """Views that break TMA's 16-byte rules (a base 2 bytes off, a row stride
    of d + 4 elements) are copied by the wrappers, never handed to the tensor
    maps, and give the plain versions' results."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention import _strided_ok

    g = torch.Generator().manual_seed(12)
    b, h, l = 1, 2, 200
    q, k, v, dout = _peaky_qkv(b, h, l, g, cuda, d)
    n = q.numel()

    def shifted(x):
        flat = torch.empty(n + 8, dtype=x.dtype, device=cuda)
        y = flat[1:1 + n].view(x.shape)
        y.copy_(x)
        return y

    def wide(x):
        buf = torch.zeros(b, h, l, d + 4, dtype=x.dtype, device=cuda)
        buf[..., :d] = x
        return buf[..., :d]

    pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v)
    pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, None, pout, plse, dout)
    for make in (shifted, wide):
        qq, kk, vv, dd = (make(x) for x in (q, k, v, dout))
        assert not _strided_ok(qq)
        out, lse = flash_attention.flash_attention_fwd(qq, kk, vv)
        assert (out.float() - pout.float()).abs().max().item() < 0.04
        torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-3)
        grads = flash_attention.flash_attention_bwd(qq, kk, vv, None, make(pout), plse, dd)
        for got, want in zip(grads, pgrads):
            assert (got.float() - want.float()).abs().max().item() <= 0.01 * want.float().abs().max().item()


# -- the flash kernels in f32 (csrc/flash_attention_f32.cu at head dim 64,
# csrc/flash_attention_f32_wide.cu at 128, 192 and 256) --

FLASH_F32_EDGES = (1, 31, 33, 63, 64, 65, 127, 128, 129, 768, 1249)
F32_HEAD_DIMS = (64, 128, 192, 256)


def _peaky_f32(b, h, l, g, cuda, d=64):
    """f32 q, k, v, dout (B, H, L, D), scores of std ~6 as `_peaky_qkv`."""
    q, k, v, dout = (torch.randn(b, h, l, d, generator=g).to(cuda) for _ in range(4))
    return q * (6.0 / d ** 0.5), k, v, dout


def _unit_f32(b, h, l, g, cuda, d=64):
    """Unit-scale f32 q, k, v, dout (B, H, L, D): N(0, 1), q with the model's
    D^-1/2 prescale (scores of std 1), the inputs the f32 tolerances are
    stated for."""
    q, k, v, dout = (torch.randn(b, h, l, d, generator=g).to(cuda) for _ in range(4))
    return q / d ** 0.5, k, v, dout


def _f32_matches(got, want, lse=None, plse=None, grads=(), pgrads=(), floor=0.0, grad_abs=1e-3):
    """The f32 kernels' tolerances (the JAX package's own f32 flash tests,
    TF32 off in the plain versions): out and lse within 1e-4; each gradient
    within `grad_abs` (1e-3, the bound for unit-scale inputs) and within
    1e-4 of its max |value| (+ `floor` where the gradient is 0 up to
    rounding: at L = 1 ds = p (dp - delta) is the rounding of dp and delta,
    and dq, dk are ~1e-5)."""
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err
    if lse is not None:
        err = (lse - plse).abs().max().item()
        assert err <= 1e-4, err
    for g, pg in zip(grads, pgrads):
        assert g.dtype == torch.float32
        err, scale = (g - pg).abs().max().item(), pg.abs().max().item()
        assert err <= grad_abs and err <= 1e-4 * scale + floor, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("l", FLASH_F32_EDGES)
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_flash_f32_tiles_and_edges_match_plain_on_card(cuda, d, l):
    """The f32 kernels against the plain versions at every edge of their
    tiles (64 rows at head dim 64, 32 past it): no bias and a ragged bias,
    dropout 0 and 0.1 (the bf16 kernels' hash bits), q/k/v contiguous and
    as projection head views.  The scores have std 6: past head dim 64 the
    gradients reach a scale of ~70 (dq 1.02e-3 off at D = 192, L = 1249:
    1.5e-5 of it), so there they are held by the relative bound alone, as
    `test_flash_f32_long_peaky_scores_within_relative_bound_on_card` holds
    std-6 scores at every head dim."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention import _strided_ok

    g = torch.Generator().manual_seed(2000 + l + d)
    q, k, v, dout = _peaky_f32(2, 3, l, g, cuda, d)
    ragged = torch.zeros(2, l)
    ragged[1, max(1, (2 * l) // 3):] = -10000.0
    ragged = ragged.to(cuda)
    views = (q, k, v), tuple(_proj_view(x) for x in (q, k, v))
    assert _strided_ok(views[1][0]) and (l == 1 or not views[1][0].is_contiguous())
    for bias in (None, ragged):
        for rate in (0.0, 0.1):
            pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=rate, seed=5)
            pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, bias, pout, plse, dout,
                                                               dropout_rate=rate, seed=5)
            for qq, kk, vv in views:
                out, lse = flash_attention.flash_attention_fwd(qq, kk, vv, bias, dropout_rate=rate, seed=5)
                dd = dout if qq is q else _proj_view(dout)
                grads = flash_attention.flash_attention_bwd(qq, kk, vv, bias, pout, plse, dd,
                                                            dropout_rate=rate, seed=5)
                assert out.dtype == torch.float32
                _f32_matches(out, pout, lse, plse, grads, pgrads, floor=1e-4 if l == 1 else 0.0,
                             grad_abs=1e-3 if d == 64 else math.inf)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [5999, 8192])
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_flash_f32_long_sequences_match_plain_on_card(cuda, d, l):
    """Past 4096 frames (JAX's kv-blocked kernels): f32 forward and backward
    with dropout 0.1 and a ragged key bias against the plain versions, on
    unit-scale inputs (the 1e-3 on a gradient is absolute: the sums over L
    keys grow with the gradients' scale, which the 1e-4 relative bound
    follows)."""
    g = torch.Generator().manual_seed(l + d)
    q, k, v, dout = _unit_f32(1, 2, l, g, cuda, d)
    bias = torch.zeros(1, l)
    bias[0, (2 * l) // 3:] = -10000.0
    bias = bias.to(cuda)
    out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, dropout_rate=0.1, seed=7)
    pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=0.1, seed=7)
    grads = flash_attention.flash_attention_bwd(q, k, v, bias, pout, plse, dout, dropout_rate=0.1, seed=7)
    pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, bias, pout, plse, dout,
                                                       dropout_rate=0.1, seed=7)
    _f32_matches(out, pout, lse, plse, grads, pgrads)


@pytest.mark.cuda
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_flash_f32_launches_are_deterministic_on_card(cuda, d):
    """No float atomics in f32 either: two launches of the forward and of the
    backward give equal bits (dropout, ragged bias, a ragged last tile)."""
    g = torch.Generator().manual_seed(13 + d)
    q, k, v, dout = _peaky_f32(2, 4, 1000, g, cuda, d)
    bias = torch.zeros(2, 1000)
    bias[0, 700:] = -10000.0
    bias = bias.to(cuda)
    runs = []
    for _ in range(2):
        out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, dropout_rate=0.1, seed=3)
        grads = flash_attention.flash_attention_bwd(q, k, v, bias, out, lse, dout,
                                                    dropout_rate=0.1, seed=3)
        runs.append((out, lse) + tuple(grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_flash_f32_misaligned_views_are_copied_on_card(cuda, d):
    """f32 views that break TMA's 16-byte rules (a base 4 bytes off, a row
    stride of D + 2 elements: 264 bytes at 64) are copied by the wrappers and
    give the plain versions' results."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels.flash_attention import _strided_ok

    g = torch.Generator().manual_seed(14 + d)
    b, h, l = 1, 2, 200
    q, k, v, dout = _peaky_f32(b, h, l, g, cuda, d)
    n = q.numel()

    def shifted(x):
        flat = torch.empty(n + 8, dtype=x.dtype, device=cuda)
        y = flat[1:1 + n].view(x.shape)
        y.copy_(x)
        return y

    def wide(x):
        buf = torch.zeros(b, h, l, d + 2, dtype=x.dtype, device=cuda)
        buf[..., :d] = x
        return buf[..., :d]

    pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v)
    pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, None, pout, plse, dout)
    for make in (shifted, wide):
        qq, kk, vv, dd = (make(x) for x in (q, k, v, dout))
        assert not _strided_ok(qq)
        out, lse = flash_attention.flash_attention_fwd(qq, kk, vv)
        grads = flash_attention.flash_attention_bwd(qq, kk, vv, None, make(pout), plse, dd)
        _f32_matches(out, pout, lse, plse, grads, pgrads)


@pytest.mark.cuda
def test_f32_step_on_card_goes_through_the_flash_kernels(cuda):
    """An f32 stage-2 step of a small model with heads of 64 launches the f32
    flash forward and backward once a layer (no other kernel but CTC's), and
    its loss and gradients match the same step through the plain attention
    on the card (TF32 off): loss rtol 1e-5, gradients 1e-4 of their scale
    + 1e-5 (k_proj's bias has a gradient of 0 up to rounding: the softmax
    does not see a shift common to all keys)."""
    from gsoc_wav2vec2_tpu_torch.training import make_ctc_loss_fn, set_trainable

    cfg = Wav2Vec2Config(**{**SMALL_BASE, "dropout": 0.1})
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    batch = {"speech": torch.randn(2, 16000, generator=g),
             "labels": torch.randint(1, cfg.vocab_size, (2, 8), generator=g)}
    set_trainable(model, ("feature_extractor",))
    loss_fn = make_ctc_loss_fn(cfg, division_factor=2, compute_dtype=torch.float32, remat=False)
    results = []
    for kernels in (True, False):
        model.zero_grad(set_to_none=True)
        _zero_launches()
        saved = flash_attention.supports
        if not kernels:
            flash_attention.supports = lambda *a, **kw: False
        try:
            loss = loss_fn(model, batch, torch.Generator().manual_seed(7))
            loss.backward()
        finally:
            flash_attention.supports = saved
        torch.cuda.synchronize()
        launches = _launches_since_zero()
        n = cfg.num_layers if kernels else 0
        assert launches == {k: n if k.startswith("flash") else 0 for k in ALL_KERNELS}, launches
        results.append((loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()
                                      if p.grad is not None}))
    (loss, grads), (ploss, pgrads) = results
    assert abs(loss - ploss) <= 1e-5 * abs(ploss)
    for name, gk in grads.items():
        scale = pgrads[name].abs().max().item()
        err = (gk - pgrads[name]).abs().max().item()
        assert err <= 1e-4 * scale + 1e-5, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_flash_f32_long_peaky_scores_within_relative_bound_on_card(cuda, d):
    """Scores of std 6 at L = 8192 (dropout 0.1, ragged key bias): the
    gradients grow with the scores' scale, so they are held within 1e-4 of
    their max |value| (1.5e-3 off at a dq scale of 63 at head dim 64), out
    and lse within 1e-4, beside the unit-scale long case."""
    l = 8192
    g = torch.Generator().manual_seed(60 + d)
    q, k, v, dout = _peaky_f32(1, 2, l, g, cuda, d)
    bias = torch.zeros(1, l)
    bias[0, (2 * l) // 3:] = -10000.0
    bias = bias.to(cuda)
    out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, dropout_rate=0.1, seed=9)
    pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=0.1, seed=9)
    grads = flash_attention.flash_attention_bwd(q, k, v, bias, pout, plse, dout, dropout_rate=0.1, seed=9)
    pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, bias, pout, plse, dout,
                                                       dropout_rate=0.1, seed=9)
    assert (out - pout).abs().max().item() <= 1e-4
    assert (lse - plse).abs().max().item() <= 1e-4
    for got, want in zip(grads, pgrads):
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d", F32_HEAD_DIMS[1:])
def test_flash_f32_wide_fully_masked_rows_match_plain_on_card(cuda, d):
    """A batch row whose one key is masked (-10000, L = 1): its score is ~
    -1e4, where one f32 ulp is ~1e-3.  The wide f32 kernels add the bias in
    the natural domain, as JAX's kernel does, so p = 1 and lse = s exactly,
    as in the plain versions.  (Past L = 1 such a row's softmax runs over
    scores on f32's ~1e-3 grid at 1e4, in the plain version too: its
    output is that grid's, and no bound of 1e-4 holds it.)"""
    l = 1
    g = torch.Generator().manual_seed(70 + d)
    q, k, v, dout = _unit_f32(2, 3, l, g, cuda, d)
    bias = torch.zeros(2, l)
    bias[1] = -10000.0
    bias = bias.to(cuda)
    for rate in (0.0, 0.1):
        out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, dropout_rate=rate, seed=2)
        pout, plse = flash_attention.flash_attention_fwd_plain(q, k, v, bias, dropout_rate=rate, seed=2)
        grads = flash_attention.flash_attention_bwd(q, k, v, bias, pout, plse, dout, dropout_rate=rate,
                                                    seed=2)
        pgrads = flash_attention.flash_attention_bwd_plain(q, k, v, bias, pout, plse, dout,
                                                           dropout_rate=rate, seed=2)
        _f32_matches(out, pout, lse, plse, grads, pgrads, floor=1e-4)


@pytest.fixture
def cli_determinism():
    """What the training CLIs set (`training.deterministic_training`), undone
    after the test."""
    from gsoc_wav2vec2_tpu_torch.training import deterministic_training

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    deterministic_training()
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.cuda
def test_f32_robust_steps_are_bit_equal_under_the_cli_settings(cuda, cli_determinism):
    """Two identical f32 stage-2 losses and gradients of the robust family
    (full width, 2 layers, dropout 0.1, SpecAugment, a ragged mask) are
    bit-equal under the settings the training CLIs make: the f32 pos conv is
    cuDNN's grouped conv, whose default backward differs run to run."""
    from gsoc_wav2vec2_tpu_torch.models.config import RobustWav2Vec2Config
    from gsoc_wav2vec2_tpu_torch.training import make_ctc_loss_fn, set_trainable

    cfg = RobustWav2Vec2Config(num_layers=2)
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    mask = torch.ones(2, 32000, dtype=torch.int32)
    mask[1, 21000:] = 0
    batch = {"speech": torch.randn(2, 32000, generator=g) * mask,
             "labels": torch.randint(1, cfg.vocab_size, (2, 12), generator=g), "attention_mask": mask}
    set_trainable(model, ("feature_extractor",))
    loss_fn = make_ctc_loss_fn(cfg, division_factor=2, with_attention_mask=True, length_aware=True,
                               compute_dtype=torch.float32, remat=False)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, torch.Generator().manual_seed(7))
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                   if p.grad is not None}))
    (loss, grads), (again, regrads) = runs
    assert loss == again and torch.isfinite(torch.tensor(loss))
    assert any("pos_conv" in n for n in grads)
    assert [n for n in grads if not torch.equal(grads[n], regrads[n])] == []


# -- the conv front-end kernels (wgmma + TMA multicast) and the F1 dispatch --

def _conv_inputs(robust, c, b, t1, g, cuda, extra=7):
    """A waveform whose conv1 output has exactly t1 rows (extra < 10 samples
    past the last window), and each family's parameters at width c."""
    length = 10 * t1 + 10 + extra
    assert conv_frontend.conv1_length(length) == t1
    wave = torch.randn(b, length, generator=g).to(cuda, torch.bfloat16)
    if robust:
        return wave, _robust_frontend_inputs(c, length, g, cuda, b)[1]
    w0 = (torch.randn(10, 1, c, generator=g) * 0.3).to(cuda)
    w1 = (torch.randn(3, c, c, generator=g) * (1.5 / c ** 0.5)).to(cuda)
    gamma = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    beta = (0.1 * torch.randn(c, generator=g)).to(cuda)
    t0 = conv_frontend.conv0_length(length)
    gram, rsum = conv_frontend.window_stats_plain(wave, t0)
    scale, shift = conv_frontend.groupnorm_scale_shift(gram, rsum, w0, gamma, beta, t0, 1e-5)
    return wave, (w0, scale, shift, w1)


def _conv_pair(robust, wave, params, t1, out_dtype=torch.bfloat16):
    """(kernel, plain) calls; the plain one returns `out_dtype`."""
    if robust:
        return (lambda: conv_frontend.conv01_robust(wave, *params, t1, 1e-5, True),
                lambda: conv_frontend.conv01_robust_plain(wave, *params, t1, 1e-5, True,
                                                          out_dtype))
    w0, scale, shift, w1 = params
    return (lambda: conv_frontend.conv01(wave, w0, scale, shift, w1, t1, True),
            lambda: conv_frontend.conv01_plain(wave, w0, scale, shift, w1, t1, True, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("t1,b", [(1, 1), (63, 1), (64, 1), (65, 1), (127, 1), (128, 1),
                                  (129, 1), (65, 3), (24599, 2)])
@pytest.mark.parametrize("c", conv_frontend.KERNEL_WIDTHS)
@pytest.mark.parametrize("robust", [False, True])
def test_conv01_kernels_match_plain_at_tile_edges(cuda, robust, c, t1, b):
    """Both conv front-end kernels against their plain versions at every
    instance width, every tile edge (64 rows a tile), odd tile counts (a
    cluster partner past the last tile), and the main path's 24599 rows."""
    g = torch.Generator().manual_seed(c + t1 + b)
    wave, params = _conv_inputs(robust, c, b, t1, g, cuda)
    kernel, plain = _conv_pair(robust, wave, params, t1)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, t1, c) and got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    if c in (256, 512):
        # bf16 outputs (ulp 2^-6 at |y| in [2, 4)) over f32 sums in another order
        assert d.max().item() < 0.05 and d.mean().item() < 5e-3
        return
    # the widths added beside 256 and 512: the base family's outputs reach
    # |y| = 8 at 24599 x 2 rows, where two bf16 roundings of sums in another
    # order may fall one ulp (2^-4) apart, so the maximum is held against the
    # plain version's value before its last rounding
    exact = _conv_pair(robust, wave, params, t1, torch.float32)[1]()
    assert (got.float() - exact).abs().max().item() < 0.05 and d.mean().item() < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("c", [512, 384, 1024])
@pytest.mark.parametrize("robust", [False, True])
def test_conv01_launches_are_bit_equal_on_card(cuda, robust, c):
    """Every output element comes from one CTA in a fixed k order (from 640
    the robust LayerNorm's two column halves combined in column order): two
    launches give equal bits."""
    g = torch.Generator().manual_seed(21)
    wave, params = _conv_inputs(robust, c, 2, 3001, g, cuda)
    kernel, _ = _conv_pair(robust, wave, params, 3001)
    first = kernel()
    assert torch.equal(kernel(), first)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [192, 1152])
@pytest.mark.parametrize("robust", [False, True])
def test_conv01_widths_without_an_instance_raise_on_card(cuda, robust, c):
    """A width without an instance (no multiple of 128, or past 1024) is
    refused by `supports`, raises in the wrapper and is an error at the C
    entry; nothing runs the plain version in its place."""
    from gsoc_wav2vec2_tpu_torch.models.config import RobustWav2Vec2Config
    from gsoc_wav2vec2_tpu_torch.ops.kernels import _build

    family = RobustWav2Vec2Config if robust else Wav2Vec2Config
    assert not conv_frontend.supports(family(filter_sizes=[c] * 7))
    g = torch.Generator().manual_seed(23)
    wave, params = _conv_inputs(robust, c, 1, 65, g, cuda)
    kernel, _ = _conv_pair(robust, wave, params, 65)
    with pytest.raises(ValueError, match="KERNEL_WIDTHS|C in"):
        kernel()
    out = torch.empty((1, 65, c), dtype=torch.bfloat16, device=cuda)
    w0 = conv_frontend._taps16(params[0], c)
    w1 = params[4 if robust else 3].to(torch.bfloat16).contiguous()
    lib = _build.library()
    if robust:
        p = torch.zeros((3, c), device=cuda)
        err = lib.w2v2_conv01_robust(wave.data_ptr(), w0.data_ptr(), p.data_ptr(), w1.data_ptr(),
                                     p.data_ptr(), out.data_ptr(), 1, wave.shape[1], 65, c, 1e-5,
                                     _build.stream_of(wave))
    else:
        ss = params[1].contiguous()
        err = lib.w2v2_conv01(wave.data_ptr(), w0.data_ptr(), ss.data_ptr(), ss.data_ptr(),
                              w1.data_ptr(), out.data_ptr(), 1, wave.shape[1], 65, c,
                              _build.stream_of(wave))
    assert err != 0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [512, 384, 1024])
@pytest.mark.parametrize("b,length", [(16, 246000), (1, 1_920_000), (3, 24007), (2, 16000)])
def test_groupnorm_stats_matches_plain_on_card(cuda, b, length, c):
    """The one-launch GroupNorm statistics against `groupnorm_stats_plain` at
    the base batch, the long path's 120 s and a length that is no multiple
    of 8 samples (a padded copy), at three front-end widths; no float
    atomics: two launches give equal bits."""
    g = torch.Generator().manual_seed(22 + b)
    x = (torch.randn(b, length, generator=g) + 0.3).to(cuda, torch.bfloat16)
    w0 = (torch.randn(10, 1, c, generator=g) * 0.3).to(cuda)
    gamma = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    beta = (0.1 * torch.randn(c, generator=g)).to(cuda)
    t0 = conv_frontend.conv0_length(length)
    conv_frontend.groupnorm_stats.launches = 0
    first = conv_frontend.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
    second = conv_frontend.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
    assert conv_frontend.groupnorm_stats.launches == 2
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    for got, want in zip(first, conv_frontend.groupnorm_stats_plain(x, t0, w0, gamma, beta, 1e-5)):
        assert got.shape == (b, c) and got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


SMALL_BASE = dict(hidden_size=128, num_heads=2, num_layers=2, intermediate_size=256,
                  filter_sizes=[256] * 7, num_conv_pos_embedding_groups=8,
                  dropout=0.0, apply_spec_augment=False)


@pytest.mark.cuda
def test_base_forward_is_bit_reproducible_on_card(cuda):
    """Two base forwards of one batch through the kernels give equal bits."""
    cfg = Wav2Vec2Config(**SMALL_BASE)
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(4))
    x = torch.randn(2, 64000, generator=torch.Generator().manual_seed(5)).to(cuda)
    conv_frontend.groupnorm_stats.launches = 0
    with torch.inference_mode():
        first, second = model(x), model(x)
    assert conv_frontend.groupnorm_stats.launches == 2
    assert torch.equal(first, second)


# the JAX tests' tiny_config (tests/utils.py): hidden 64 with 4 heads (D = 16),
# conv width 32, pos conv 16 groups (C/G = 4): no kernel instance covers it
TINY = dict(vocab_size=32, hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32] * 7, kernal_sizes=[10, 3, 3, 3, 3, 2, 2],
            strides=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=128,
            num_conv_pos_embedding_groups=16, dropout=0.0, apply_spec_augment=False)

ALL_KERNELS = {"groupnorm_stats": conv_frontend.groupnorm_stats, "conv01": conv_frontend.conv01,
               "conv01_robust": conv_frontend.conv01_robust, "pos_conv": pos_conv.pos_conv,
               "pos_conv_train_fwd": pos_conv.pos_conv_train_fwd,
               "pos_conv_dx": pos_conv.pos_conv_dx, "pos_conv_dw": pos_conv.pos_conv_dw,
               "flash_attention_fwd": flash_attention.flash_attention_fwd,
               "flash_attention_bwd": flash_attention.flash_attention_bwd}


def _launches_since_zero():
    return {k: fn.launches for k, fn in ALL_KERNELS.items()}


def _zero_launches():
    for fn in ALL_KERNELS.values():
        fn.launches = 0


@pytest.mark.cuda
@pytest.mark.parametrize("robust", [False, True])
def test_tiny_config_forward_and_step_run_on_card(cuda, robust):
    """Where no kernel instance covers the config, every site takes its plain
    op on the card, as the JAX package takes XLA's: a bf16 forward and a
    stage-2 step run with every kernel count 0, and the forward tracks the
    f32 CPU copy."""
    from gsoc_wav2vec2_tpu_torch.models.config import RobustWav2Vec2Config
    from gsoc_wav2vec2_tpu_torch.training import (
        create_optimizer, create_train_state, make_train_step, set_trainable)

    cfg = (RobustWav2Vec2Config if robust else Wav2Vec2Config)(**TINY)
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16000, generator=g)
    _zero_launches()
    with torch.inference_mode():
        logits = model(x.to(cuda))
        torch.cuda.synchronize()
    assert all(n == 0 for n in _launches_since_zero().values())
    assert torch.isfinite(logits).all()
    cpu = copy.deepcopy(model).to("cpu")  # before the steps change the weights
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(cpu, cfg, x)
    assert (logits.float().cpu() - ref).abs().max().item() < 0.1 * (1 + ref.abs().max().item())
    labels = torch.randint(1, cfg.vocab_size, (2, 8), generator=g)
    batch = {"speech": x, "labels": labels}
    set_trainable(model, ("feature_extractor",))
    state = create_train_state(model, create_optimizer(model, 1e-3))
    step = make_train_step(cfg, division_factor=2)
    losses = []
    for i in range(3):
        state, metrics = step(state, batch, torch.Generator().manual_seed(i))
        losses.append(metrics["loss"].item())
    assert all(n == 0 for n in _launches_since_zero().values())
    assert all(torch.isfinite(torch.tensor(losses)))


@pytest.mark.cuda
@pytest.mark.parametrize("small", ["tiny", "kernel_widths"])
def test_f32_forward_on_card_matches_cpu(cuda, small):
    """An f32 forward on the card (TF32 off, as the fixture sets it) takes
    the flash kernels' f32 instance where the head dim is 64 (one launch a
    layer) and the plain op at every other site, also at widths the bf16
    kernels cover, and matches the f32 CPU copy at the JAX parity tests'
    logits tolerance."""
    cfg = Wav2Vec2Config(**(TINY if small == "tiny" else SMALL_BASE))
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(2))
    x = torch.randn(2, 16000, generator=torch.Generator().manual_seed(3))
    _zero_launches()
    with torch.inference_mode():
        logits = wav2vec2_for_ctc_forward(model, cfg, x.to(cuda), compute_dtype=torch.float32)
        torch.cuda.synchronize()
    d = cfg.hidden_size // cfg.num_heads
    flash = cfg.num_layers if d == 64 else 0
    assert (small == "kernel_widths") == (d == 64)
    assert _launches_since_zero() == {k: flash if k == "flash_attention_fwd" else 0 for k in ALL_KERNELS}
    assert logits.dtype == torch.float32
    cpu = model.to("cpu")
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(cpu, cfg, x, compute_dtype=torch.float32)
    assert (logits.cpu() - ref).abs().max().item() < 4e-3


@pytest.mark.cuda
def test_server_answers_on_card(cuda):
    """A small base server on the card (`cli.serve`'s batcher and handler on
    a thread of this process) answers a pair of concurrent requests in one
    batch through the kernels, with the transcripts the same evaluator gives
    in process for each request's padded (max_batch, bucket) batch."""
    import io
    import json
    import threading
    import urllib.request
    import wave
    from http.server import ThreadingHTTPServer

    import numpy as np

    from gsoc_wav2vec2_tpu_torch.cli import serve
    from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor
    from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator

    model = Wav2Vec2ForCTC(Wav2Vec2Config(**SMALL_BASE), device=cuda,
                           generator=torch.Generator().manual_seed(6))
    evaluator = GreedyCTCEvaluator(model)
    batcher = serve.DynamicBatcher(evaluator, buckets=(16000, 32000), max_batch=4, window_ms=300.0)
    batcher.warmup()
    batcher.start()
    processor = Wav2Vec2Processor(is_tokenizer=False)
    stats = {"requests": 0, "streams": 0, "aligns": 0}
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(batcher, processor, stats))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(7)
    audios = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (18000, 26000)]

    def wav(audio):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
        return buf.getvalue()

    results = [None, None]

    def post(i):
        req = urllib.request.Request(base + "/v1/transcribe", data=wav(audios[i]),
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            results[i] = json.loads(resp.read())

    _zero_launches()
    try:
        clients = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
            assert not t.is_alive()
        torch.cuda.synchronize()
        launches = _launches_since_zero()
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    # the pair lands in the 32000 bucket together: one forward through the kernels
    assert [r["batched_with"] for r in results] == [2, 2]
    assert launches["groupnorm_stats"] == launches["conv01"] == launches["pos_conv"] == 1
    assert launches["flash_attention_fwd"] == SMALL_BASE["num_layers"]
    from gsoc_wav2vec2_tpu_torch.data.native_io import decode_wav_bytes

    for audio, got in zip(audios, results):
        speech = np.asarray(processor(decode_wav_bytes(wav(audio))[0]), np.float32)
        batch = np.zeros((4, 32000), np.float32)
        batch[0, : len(speech)] = speech
        want = evaluator.predict_segments(batch, np.array([len(speech), 0, 0, 0]))[0][0]
        assert got["transcription"] == want


def _ctc_case(cuda, b, t, v, n, seed):
    g = torch.Generator().manual_seed(seed)
    log_probs = torch.log_softmax(2.0 * torch.randn(b, t, v, generator=g), -1).to(cuda)
    labels = torch.zeros(b, n, dtype=torch.int64)
    for i in range(b):
        m = int(torch.randint(1, n + 1, (), generator=g))
        labels[i, :m] = torch.randint(1, 4 if i % 2 else v, (m,), generator=g)  # odd rows repeat
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    # n equal labels need 2n - 1 frames: infeasible in n (one label fits one
    # frame, so at width 1 the row gets none)
    labels[-1], lengths[-1] = 1, n if n > 1 else 0
    return log_probs, labels.to(cuda), lengths.to(cuda)


def _ctc_run(fn, log_probs, labels, lengths):
    x = log_probs.clone().requires_grad_(True)
    loss = fn(x, labels, lengths)
    loss.sum().backward()
    torch.cuda.synchronize()
    return loss.detach(), x.grad


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,v,n", [
    (4, 120, 32, 30), (3, 777, 32, 200), (1, 2000, 8, 900), (3, 90, 8192, 40),
    # each kernel instance's edges: label widths 1 and 31-33 (one warp of one
    # slot a lane), 255 / 256 (the backward's single chain warp), 511 / 512,
    # 1023 / 1024, 2047 / 2048 (the forward's 1, 2, 4, 8 slots a lane)
    (2, 40, 32, 1), (2, 100, 32, 31), (2, 100, 32, 32), (2, 100, 32, 33), (2, 300, 32, 255),
    (2, 300, 32, 256), (2, 300, 32, 511), (2, 300, 32, 512), (2, 300, 32, 1023),
    (2, 300, 32, 1024), (2, 300, 32, 2047), (2, 300, 32, 2048),
    # the long cell's frames and a subword vocabulary at the recipe's labels
    (2, 5999, 32, 200), (4, 400, 8192, 200)])
def test_ctc_kernel_matches_plain_on_card(cuda, b, t, v, n):
    """The CTC kernels against `ctc_loss_plain` on the card: loss rtol 1e-5,
    gradient atol 1e-5; the infeasible row finite (loss >= 1e4), no gradient
    past a row's logit length; a subword vocabulary (V = 8192) too; at the
    edges of every kernel instance (`ctc.plan`)."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc

    log_probs, labels, lengths = _ctc_case(cuda, b, t, v, n, seed=b + t)
    ctc.ctc_loss_fwd.launches = ctc.ctc_loss_bwd.launches = 0
    loss, grad = _ctc_run(ctc.ctc_loss, log_probs, labels, lengths)
    assert (ctc.ctc_loss_fwd.launches, ctc.ctc_loss_bwd.launches) == (1, 1)
    want, want_grad = _ctc_run(ctc.ctc_loss_plain, log_probs, labels, lengths)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=1e-5)
    assert loss[-1].item() >= 1e4
    past = torch.arange(t, device=cuda)[None, :] >= lengths[:, None]
    assert not grad[past].any()


@pytest.mark.cuda
def test_ctc_infeasible_row_is_finite_on_card(cuda):
    """The row whose 8 labels cannot fit 10 frames: optax's finite 100014.2
    through the kernels, where `F.ctc_loss` gives inf."""
    from gsoc_wav2vec2_tpu_torch.ops.ctc import ctc_loss_fn

    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 10, 8, generator=g).to(cuda)
    labels = torch.tensor([[1, 2, 3, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1, 2, 2]], device=cuda)
    x = logits.clone().requires_grad_(True)
    loss = ctc_loss_fn(x, labels, torch.tensor([10, 10]), 0)
    loss.sum().backward()
    assert torch.isfinite(loss).all() and torch.isfinite(x.grad).all()
    assert 1e5 < loss[1].item() < 1.01e5
    y = logits.cpu().requires_grad_(True)
    cpu = ctc_loss_fn(y, labels.cpu(), torch.tensor([10, 10]), 0)
    cpu.sum().backward()
    torch.testing.assert_close(loss.cpu(), cpu.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(x.grad.cpu(), y.grad, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_ctc_wide_labels_raise_and_no_labels_run_on_card(cuda):
    """More than `MAX_LABELS` label positions raise on the card (it has no
    plain loop to fall back to); a label tensor of width 0 runs the kernels
    and matches `ctc_loss_plain`."""
    from gsoc_wav2vec2_tpu_torch.ops.ctc import ctc_loss_fn
    from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc

    g = torch.Generator().manual_seed(3)
    log_probs = torch.log_softmax(torch.randn(2, 16, 8, generator=g), -1).to(cuda)
    lengths = torch.tensor([16, 9], device=cuda)
    wide = torch.ones(2, ctc.MAX_LABELS + 1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="label positions"):
        ctc_loss_fn(log_probs, wide, lengths, 0)
    empty = torch.zeros(2, 0, dtype=torch.int64, device=cuda)
    ctc.ctc_loss_fwd.launches = ctc.ctc_loss_bwd.launches = 0
    loss, grad = _ctc_run(ctc.ctc_loss, log_probs, empty, lengths)
    assert (ctc.ctc_loss_fwd.launches, ctc.ctc_loss_bwd.launches) == (1, 1)
    want, want_grad = _ctc_run(ctc.ctc_loss_plain, log_probs, empty, lengths)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 100, 768), (2, 50, 1024)])
def test_layer_norm_fused_matches_plain_on_card(cuda, shape):
    """The card's `layer_norm` (one fused `F.layer_norm`) against
    `layer_norm_plain` (the JAX package's sequence, which the CPU runs and
    the JAX-parity tests hold) on the card: output and input gradient atol
    1e-5 in f32."""
    from gsoc_wav2vec2_tpu_torch.ops.basic import layer_norm, layer_norm_plain

    g = torch.Generator().manual_seed(shape[-1])
    x = (3 * torch.randn(shape, generator=g) + 1).to(cuda).requires_grad_(True)
    gamma = (1 + 0.1 * torch.randn(shape[-1], generator=g)).to(cuda)
    beta = (0.1 * torch.randn(shape[-1], generator=g)).to(cuda)
    dy = torch.randn(shape, generator=g).to(cuda)
    outs = []
    for fn in (layer_norm, layer_norm_plain):
        y = fn(x, gamma, beta)
        outs.append((y.detach(), torch.autograd.grad(y, x, dy)[0]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_ctc_log1p_is_the_math_library_on_card(cuda):
    """The kernels' branch-free log1p gives log1pf's bits on every float in
    [0, 1] (all its log-add-exps take), so the kernels' arithmetic is the
    plain version's."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc

    assert ctc.log1p_mismatches() == 0


@pytest.mark.cuda
def test_ctc_two_backwards_are_bit_equal_on_card(cuda):
    """No float atomics: the same inputs give the same loss and gradient bits."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc

    log_probs, labels, lengths = _ctc_case(cuda, 32, 768, 32, 200, seed=5)
    runs = [_ctc_run(ctc.ctc_loss, log_probs, labels, lengths) for _ in range(3)]
    for loss, grad in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(grad, runs[0][1])


@pytest.mark.cuda
def test_remat_step_is_bit_equal_on_card(cuda):
    """A stage-2 step with remat "dots" and "full" gives the gradients and
    parameters of the step without remat, bit for bit, through the flash and
    pos-conv autograd functions (dropout 0.1, SpecAugment: the layers' draws
    are taken before the first layer); under remat the attention forward
    runs twice a layer."""
    from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc
    from gsoc_wav2vec2_tpu_torch.training import (
        create_optimizer, create_train_state, make_train_step, set_trainable)

    cfg = Wav2Vec2Config(hidden_size=128, num_heads=2, num_layers=2, intermediate_size=256,
                         filter_sizes=[256] * 7, num_conv_pos_embedding_groups=8,
                         dropout=0.1, mask_time_length=4)
    g = torch.Generator().manual_seed(1)
    batch = {"speech": torch.randn(2, 32000, generator=g),
             "labels": torch.randint(1, cfg.vocab_size, (2, 8), generator=g)}
    kernels = {"flash_attention_fwd": flash_attention.flash_attention_fwd,
               "flash_attention_bwd": flash_attention.flash_attention_bwd,
               "pos_conv_train_fwd": pos_conv.pos_conv_train_fwd, "ctc_loss_bwd": ctc.ctc_loss_bwd}
    results = {}
    for remat in (False, "full", "dots"):
        model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
        set_trainable(model, ("feature_extractor",))
        state = create_train_state(model, create_optimizer(model, 1e-3))
        for fn in kernels.values():
            fn.launches = 0
        state, metrics = make_train_step(cfg, division_factor=2, remat=remat)(
            state, batch, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        assert launches == {"flash_attention_fwd": 2 * (2 if remat else 1),
                            "flash_attention_bwd": 2, "pos_conv_train_fwd": 1, "ctc_loss_bwd": 1}
        results[remat] = (metrics["loss"], {n: p.grad.clone() for n, p in model.named_parameters()
                                            if p.grad is not None},
                          {n: p.detach().clone() for n, p in model.named_parameters()})
    loss0, grads0, params0 = results[False]
    assert torch.isfinite(loss0)
    for remat in ("full", "dots"):
        loss, grads, params = results[remat]
        assert torch.equal(loss, loss0)
        assert grads.keys() == grads0.keys() and all(torch.equal(grads[k], grads0[k]) for k in grads)
        assert all(torch.equal(params[k], params0[k]) for k in params)


INFERENCE_KERNELS = ("groupnorm_stats", "conv01", "conv01_robust", "pos_conv", "flash_attention_fwd")


@pytest.mark.cuda
def test_exported_program_launches_kernels_and_matches_live_on_card(cuda, tmp_path):
    """A `torch.export` artifact made on the card keeps the kernels as
    operators: one symbolic-batch program runs B=2 and B=3 with a live
    forward's launches and the live module's bits; it refuses to load for
    the CPU."""
    from gsoc_wav2vec2_tpu_torch.export.torch_export import export_model, load_exported

    cfg = Wav2Vec2Config(**SMALL_BASE)
    model = Wav2Vec2ForCTC(cfg, device=cuda, generator=torch.Generator().manual_seed(6))
    export_model(model, str(tmp_path), seqlen=32000)
    program, meta = load_exported(str(tmp_path))
    assert meta["device"] == "cuda" and meta["batch_size"] is None
    ops = {str(n.target) for n in program.graph.nodes if str(n.target).startswith("w2v2.")}
    assert ops == {"w2v2.fused_conv01.default", "w2v2.pos_conv.default",
                   "w2v2.flash_attention_fwd.default"}
    run = program.module()
    for b in (2, 3):
        x = torch.randn(b, 32000, generator=torch.Generator().manual_seed(b)).to(cuda)
        _zero_launches()
        with torch.inference_mode():
            got = run(x)
            torch.cuda.synchronize()
            counts = _launches_since_zero()
            want = model(x)
        assert counts == {**{k: 0 for k in ALL_KERNELS}, "groupnorm_stats": 1, "conv01": 1,
                          "pos_conv": 1, "flash_attention_fwd": cfg.num_layers}
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="exported for cuda"):
        load_exported(str(tmp_path), device="cpu")


@pytest.mark.cuda
def test_hubert_large_snapshot_runs_its_kernels_on_card(cuda, tmp_path):
    """A raw HF HuBERT snapshot of the large family (stable layer norm,
    LayerNorm conv stack with bias), narrowed to kernel-covered widths, loads
    onto the card bit for bit and runs `conv01_robust`, the pos conv at 64
    channels a group and the flash forward, masked, within the robust
    bounds of the f32 CPU forward."""
    import json

    import numpy as np

    from gsoc_wav2vec2_tpu_torch.convert.hf_torch import hf_name_map
    from gsoc_wav2vec2_tpu_torch.models.config import config_from_hf_dict

    hf = {"model_type": "hubert", "vocab_size": 32, "hidden_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 2, "intermediate_size": 256, "conv_dim": [256] * 7,
          "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
          "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
          "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 2}
    cfg = config_from_hf_dict(hf)
    ref = Wav2Vec2ForCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    sd = ref.state_dict()
    names = hf_name_map(cfg, with_lm_head=True, prefix="hubert.")
    torch.save({theirs: fn(sd[ours]).contiguous() for ours, (theirs, fn) in names.items()
                if ours in sd}, str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps(hf))
    model = Wav2Vec2ForCTC.from_pretrained(str(tmp_path))
    assert all(torch.equal(v.cpu(), sd[k]) for k, v in model.state_dict().items())
    x = torch.randn(2, 32000, generator=torch.Generator().manual_seed(8))
    mask = torch.ones(2, 32000)
    mask[1, 20000:] = 0.0
    x[1, 20000:] = 0.0
    _zero_launches()
    with torch.inference_mode():
        logits = model(x.to(cuda), mask.to(cuda)).float().cpu()
        torch.cuda.synchronize()
    assert _launches_since_zero() == {**{k: 0 for k in ALL_KERNELS}, "conv01_robust": 1,
                                      "pos_conv": 1, "flash_attention_fwd": cfg.num_layers}
    with torch.inference_mode():
        want = wav2vec2_for_ctc_forward(ref, cfg, x, mask, compute_dtype=torch.float32)
    scale = want.abs().max().item()
    assert (logits[0] - want[0]).abs().max().item() <= 0.10 * scale
    agree = (logits[0].argmax(-1) == want[0].argmax(-1)).float().mean().item()
    assert agree >= 0.9 and np.isfinite(logits.numpy()).all()


def _update_rel(got, want, p0):
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in want)
    den = sum(float(((want[n].double() - p0[n].double()) ** 2).sum()) for n in want)
    return (num / den) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [[2, 1], [1, 2]], ids=["ddp", "tp"])
def test_two_rank_gloo_run_matches_one_process_on_card(cuda, tmp_path, mesh):
    """Two ranks on the one card over gloo (2-layer base-width model, bf16
    kernels): the eval logits (ddp: each rank's rows; tp: 6 heads and FFN
    1536 a rank), two stage-2 updates' losses and the parameters after them
    against one process: logits relative L2 2e-2 (bf16 products split or
    summed in another order), loss 1e-2, update-relative L2 0.5 (Adam's
    first, sign-like steps carry the bf16 differences whole); every rank
    launches the kernels."""
    import importlib.util
    import pathlib

    # by path: on the card's machine another installed package owns `tests`
    path = pathlib.Path(__file__).with_name("torch_parallel_ranks.py")
    spec = importlib.util.spec_from_file_location("torch_parallel_ranks", path)
    R = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(R)
    want = R.card_base([1, 1])
    outs = R.run_ranks("card_base", 2, {"mesh": mesh}, tmp_path, timeout=300)
    for o in outs:
        r0, r1 = o["rows"]
        ref = want["logits"][r0:r1]
        assert float((o["logits"] - ref).norm() / ref.norm()) <= 2e-2
        assert max(abs(a - b) / abs(b) for a, b in zip(o["loss"], want["loss"])) <= 1e-2
        assert _update_rel(o["params"], want["params"], want["p0"]) <= 0.5
        assert all(n > 0 for n in o["launches"]), o["launches"]


"""On-card tests of the port's CUDA kernels (marked `cuda`; they skip
without a device).  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from gsoc_wav2vec2_tpu_torch.models.config import Wav2Vec2Config
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC, wav2vec2_for_ctc_forward
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend, flash_attention, pos_conv

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
    with pytest.raises(ValueError):
        conv_frontend.window_stats(x, conv_frontend.conv0_length(24000))
    xs = torch.randn(2, 64, 768, device=cuda)
    kernel = torch.randn(128, 48, 768, device=cuda)
    with pytest.raises(ValueError):
        pos_conv.pos_conv(xs, kernel, torch.zeros(768, device=cuda), groups=16, gelu_approx=True)
    q = torch.randn(2, 4, 64, 64, device=cuda)
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
    gram, rsum = conv_frontend.window_stats(x, t0)
    pgram, prsum = conv_frontend.window_stats_plain(x, t0)
    # f32 sums in another order (atomics): 1e-5 of each matrix's scale
    torch.testing.assert_close(gram, pgram, rtol=1e-5, atol=1e-5 * pgram.abs().max().item())
    torch.testing.assert_close(rsum, prsum, rtol=1e-5, atol=1e-5 * prsum.abs().max().item())
    scale, shift = conv_frontend.groupnorm_scale_shift(pgram, prsum, w0, gamma, beta, t0, 1e-5)
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
    kernels = (conv_frontend.window_stats, conv_frontend.conv01, pos_conv.pos_conv,
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


@pytest.mark.cuda
def test_robust_family_raises_on_card(cuda):
    """The robust front end kernel is not ported: on the card the model
    raises instead of running some other path."""
    from gsoc_wav2vec2_tpu_torch.models.config import RobustWav2Vec2Config

    cfg = RobustWav2Vec2Config(hidden_size=128, num_heads=2, num_layers=1, intermediate_size=256,
                               filter_sizes=[256] * 7, num_conv_pos_embedding_groups=8,
                               dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(cfg, device=cuda)
    with pytest.raises(NotImplementedError, match="fused_conv01_robust"):
        with torch.inference_mode():
            model(torch.randn(1, 16000, device=cuda))

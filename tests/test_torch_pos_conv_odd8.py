"""The pos conv at the odd multiples of 8 below 64 channels a group (8, 24,
40 and 56), against the JAX package on the CPU.

JAX sends every bf16 pos conv whose tap count is a multiple of 16 to its
Pallas kernels, at any C/G; the port's CUDA kernels take every multiple of
8 up to 128.  At these widths a tap's contraction is half a 16-wide k step
past whole steps, and the kernels pad it with zeros.  The checks are those
of `tests/test_torch_pos_conv_widths.py`, run here at these widths (base
widths in 32 groups are 24, the robust/large widths in 128 groups 8; the
tiny models are of the base family): the
plain versions the wrappers run for a CPU tensor against `pos_conv_fused`
and `pos_conv_fused_train`'s VJP in interpret mode (g = 2, K = 32, T = 40
and 37), and tiny models of each geometry (hidden 2 C/G in 2 pos-conv
groups, 2 heads, 2 layers) against the JAX model: hidden states atol 1e-3,
logits with a ragged mask atol 4e-3, the stage-2 loss rtol 1e-5 and each
gradient within max(1e-4, 1e-5 of its largest magnitude): the loss's rtol
on the gradient's scale (f32 sums in another order; at 104 the CTC head's
kernel gradient, of scale 17.3, lay 1.2e-4 from JAX's).  Inputs come from
numpy seeds.
"""

import pytest

from tests import test_torch_pos_conv_widths as widths

ODD8 = (8, 24, 40, 56)


@pytest.mark.parametrize("t", [40, 37])
@pytest.mark.parametrize("cg", ODD8)
def test_pos_conv_plain_matches_pallas(cg, t):
    widths.test_pos_conv_plain_matches_pallas(cg, t)


@pytest.mark.parametrize("t", [40, 37])
@pytest.mark.parametrize("cg", ODD8)
def test_pos_conv_vjp_matches_pallas(cg, t):
    widths.test_pos_conv_vjp_matches_pallas(cg, t)


@pytest.mark.parametrize("cg", ODD8)
def test_tiny_model_hidden_states_match_jax(cg):
    widths.test_tiny_model_hidden_states_match_jax(cg)


@pytest.mark.parametrize("cg", ODD8)
def test_tiny_model_logits_match_jax_with_ragged_mask(cg):
    widths.test_tiny_model_logits_match_jax_with_ragged_mask(cg)


@pytest.mark.parametrize("cg", ODD8)
def test_tiny_model_stage2_loss_and_grads_match_jax(cg):
    widths.stage2_matches_jax(cg, grad_rtol=1e-5)

"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for a CPU tensor and launches the
CUDA kernel (or raises) for a CUDA tensor.

Importing this package registers the inference entry points as
`torch.library` operators (`w2v2::fused_conv01`, `w2v2::fused_conv01_robust`,
`w2v2::pos_conv`, `w2v2::flash_attention_fwd`): a process that loads a
`torch.export` artifact of the model needs this package and nothing else of
the port."""

from . import conv_frontend, flash_attention, pos_conv  # noqa: F401  (registers the operators)

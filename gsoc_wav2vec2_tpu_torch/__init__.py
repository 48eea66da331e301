"""PyTorch/CUDA port of the gsoc_wav2vec2_tpu framework, for NVIDIA Hopper.

The JAX package `gsoc_wav2vec2_tpu` stays the reference; this package
imports none of it.  The first slice covers batched bf16 inference of
`Wav2Vec2ForCTC` in the base family with greedy CTC decoding; its four
TPU kernels are hand-written CUDA kernels under `csrc/`.
"""

from .data.processor import Wav2Vec2Processor
from .evaluation import GreedyCTCEvaluator
from .models.config import RobustWav2Vec2Config, Wav2Vec2Config
from .models.modeling import Wav2Vec2ForCTC, Wav2Vec2Model

__all__ = [
    "Wav2Vec2Config",
    "RobustWav2Vec2Config",
    "Wav2Vec2ForCTC",
    "Wav2Vec2Model",
    "Wav2Vec2Processor",
    "GreedyCTCEvaluator",
]

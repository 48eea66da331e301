"""PyTorch/CUDA port of the gsoc_wav2vec2_tpu framework, for NVIDIA Hopper.

The JAX package `gsoc_wav2vec2_tpu` stays the reference; this package
imports none of it.  It covers batched bf16 inference of `Wav2Vec2ForCTC`
in both families (base and robust/large/XLSR) with greedy CTC decoding or
prefix beam search with LM fusion (`decoding.py`), word timestamps, forced
alignment and padded or bucketed WER evaluation, at any sequence length,
streaming transcription (`streaming.py`), the HTTP server and its load tool
(`cli/serve.py`, `cli/serve_bench.py`), the CTC
fine-tuning step (`training/`, stages 1 and 2 of the recipe) with its
command-line driver (`cli/train.py`, full-state checkpoints in
`training/checkpoint.py`, `cli/evaluate.py`, `cli/average.py`), weight files
in the JAX package's format (`save_pretrained` / `from_pretrained`), the data
plane (`data/`: TFRecord, WAV and FLAC through the port's own native codec,
the LibriSpeech and TIMIT loaders), and self-supervised pretraining
(`models/pretraining.py`: Gumbel quantizer, contrastive + diversity loss, the
pretraining step); the TPU kernels of these paths are hand-written CUDA
kernels under `csrc/`.
"""

from .data.processor import Wav2Vec2Processor
from .evaluation import GreedyCTCEvaluator
from .models.config import (
    RobustWav2Vec2Config,
    RobustWav2Vec2PretrainingConfig,
    Wav2Vec2Config,
    Wav2Vec2PretrainingConfig,
)
from .models.modeling import Wav2Vec2ForCTC, Wav2Vec2Model
from .models.pretraining import Wav2Vec2ForPreTraining

__all__ = [
    "Wav2Vec2Config",
    "RobustWav2Vec2Config",
    "Wav2Vec2PretrainingConfig",
    "RobustWav2Vec2PretrainingConfig",
    "Wav2Vec2ForCTC",
    "Wav2Vec2ForPreTraining",
    "Wav2Vec2Model",
    "Wav2Vec2Processor",
    "GreedyCTCEvaluator",
]

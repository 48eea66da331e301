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
pretraining step), `tf_model.h5` both ways, the convert CLI (HuBERT too),
hub ids, export (`torch.export` with the kernels as `torch.library`
operators, and ONNX) and profiling helpers; the TPU kernels of these paths
are hand-written CUDA kernels under `csrc/`.

The names below load on first use, so that importing a subpackage (as a
process that runs an exported program imports `ops.kernels` alone) does not
load the models.
"""

import importlib

_EXPORTS = {
    "Wav2Vec2Processor": ".data.processor",
    "GreedyCTCEvaluator": ".evaluation",
    "Wav2Vec2Config": ".models.config",
    "RobustWav2Vec2Config": ".models.config",
    "Wav2Vec2PretrainingConfig": ".models.config",
    "RobustWav2Vec2PretrainingConfig": ".models.config",
    "Wav2Vec2ForCTC": ".models.modeling",
    "Wav2Vec2Model": ".models.modeling",
    "Wav2Vec2ForPreTraining": ".models.pretraining",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    globals()[name] = value
    return value

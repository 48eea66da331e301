"""CLI: greedy-CTC transcription of WAV and FLAC files with the PyTorch port.

wav / flac -> normalize -> model -> argmax -> greedy-CTC decode, one JSON
line per file, as `gsoc_wav2vec2_tpu.cli.transcribe` prints them.  The model
directory is anything `Wav2Vec2ForCTC.from_pretrained` reads.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.transcribe --model_dir <dir> [--device cuda] f.wav g.flac
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.audio import read_sound
from ..data.processor import Wav2Vec2Processor
from ..evaluation import GreedyCTCEvaluator
from ..models.modeling import Wav2Vec2ForCTC


def main() -> None:
    parser = argparse.ArgumentParser("Greedy-CTC transcription (PyTorch port)")
    parser.add_argument("--model_dir", required=True, type=str)
    parser.add_argument("files", nargs="+")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="cuda (bf16 kernels; the default) or cpu (f32 plain path)",
    )
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument(
        "--chunk_samples", type=int, default=246000,
        help="long-form window size; audio longer than this is transcribed "
             "in overlapping chunks",
    )
    parser.add_argument(
        "--context_samples", type=int, default=16000,
        help="overlap context on each side of a long-form chunk",
    )
    args = parser.parse_args()

    model = Wav2Vec2ForCTC.from_pretrained(args.model_dir, device=args.device)
    evaluator = GreedyCTCEvaluator(model)
    processor = Wav2Vec2Processor(is_tokenizer=False)
    for path in args.files:
        audio, rate = read_sound(path)
        if rate != args.sample_rate:
            raise ValueError(f"{path}: sample rate {rate} != {args.sample_rate}")
        speech = np.asarray(processor(audio), np.float32)
        text = evaluator.transcribe_long(
            speech, chunk_samples=args.chunk_samples, context_samples=args.context_samples,
        )
        print(json.dumps({"file": path, "transcription": text}))


if __name__ == "__main__":
    main()

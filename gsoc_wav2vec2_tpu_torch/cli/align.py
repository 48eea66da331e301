"""CLI: forced alignment, word timestamps for a known transcript (a port of
`gsoc_wav2vec2_tpu/cli/align.py`).

`cli.transcribe --timestamps` times what the model hears; this CLI times
the transcript the caller provides (Viterbi over the CTC trellis,
`decoding.ctc_forced_align`): subtitles, karaoke, corpus segmentation.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.align --model_dir <dir> audio.wav \\
        --transcript "SHE HAD YOUR DARK SUIT"
    python -m gsoc_wav2vec2_tpu_torch.cli.align --model_dir <dir> a.wav b.flac
        # per-file transcripts from sibling a.txt / b.txt (or .TXT,
        # TIMIT-style leading sample offsets stripped)

Prints one JSON line per file: the normalised transcript and
`words` = [{"word", "start", "end", "start_frame", "end_frame",
"confidence"}, ...] with times in seconds; a file that fails prints
{"file", "error"} and the exit code is 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..data.audio import read_sound
from ..data.processor import Wav2Vec2Processor
from ..evaluation import GreedyCTCEvaluator
from ..models.modeling import Wav2Vec2ForCTC


def sibling_transcript(audio_path: str) -> str:
    """Transcript text from `<stem>.txt` / `<stem>.TXT` next to the audio.
    TIMIT-style files (two leading integer sample offsets) are detected and
    stripped."""
    stem = os.path.splitext(audio_path)[0]
    for ext in (".txt", ".TXT"):
        path = stem + ext
        if os.path.exists(path):
            with open(path) as f:
                words = f.read().split()
            if len(words) >= 2 and words[0].isdigit() and words[1].isdigit():
                words = words[2:]
            return " ".join(words)
    raise FileNotFoundError(f"no transcript for {audio_path}: pass --transcript or create {stem}.txt")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("CTC forced alignment (PyTorch port)")
    parser.add_argument("--model_dir", required=True, type=str)
    parser.add_argument("files", nargs="+")
    parser.add_argument(
        "--transcript", type=str, default=None,
        help="the text said in the (single) audio file; default: read "
             "<stem>.txt next to each file",
    )
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument(
        "--chunk_samples", type=int, default=246000,
        help="long-form window size (audio beyond it aligns in overlapping "
             "chunks on the shared frame grid)",
    )
    parser.add_argument("--context_samples", type=int, default=16000)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="cuda (bf16 kernels; the default) or cpu (f32 plain path)",
    )
    args = parser.parse_args(argv)
    if args.transcript is not None and len(args.files) != 1:
        parser.error("--transcript applies to exactly one audio file")

    model = Wav2Vec2ForCTC.from_pretrained(args.model_dir, device=args.device)
    evaluator = GreedyCTCEvaluator(model)
    processor = Wav2Vec2Processor(is_tokenizer=False)

    failures = 0
    for path in args.files:
        try:
            text_in = args.transcript if args.transcript is not None else sibling_transcript(path)
            audio, rate = read_sound(path)
            if rate != args.sample_rate:
                raise ValueError(f"{path}: sample rate {rate} != {args.sample_rate}")
            speech = np.asarray(processor(audio), np.float32)
            text, words = evaluator.align_segments(
                speech, text_in, chunk_samples=args.chunk_samples,
                context_samples=args.context_samples,
            )
        except (ValueError, OSError) as e:
            # per-file contract: no transcript, a bad rate, undecodable bytes or
            # an infeasible transcript each print a JSON error line; the batch goes on
            print(json.dumps({"file": path, "error": str(e)}), flush=True)
            failures += 1
            continue
        print(json.dumps({"file": path, "transcription": text, "words": words}), flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()

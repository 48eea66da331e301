"""CLI: transcription of WAV and FLAC files with the PyTorch port.

wav / flac -> normalize -> model -> greedy-CTC decode (or prefix beam search
with optional char n-gram LM fusion), one JSON line per file, as the JAX
package's `cli/transcribe.py` prints them: `--timestamps` adds word
start/end times and confidences, `--stream` feeds the audio in pieces
through `streaming.StreamingTranscriber` and prints each partial update.
The model directory is anything `Wav2Vec2ForCTC.from_pretrained` reads.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.transcribe --model_dir <dir> [--device cuda] f.wav g.flac
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.audio import read_sound
from ..data.processor import Wav2Vec2Processor
from ..decoding import CharNGramLM
from ..evaluation import GreedyCTCEvaluator
from ..models.modeling import Wav2Vec2ForCTC
from ..streaming import StreamingTranscriber


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("CTC transcription (PyTorch port)")
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
    parser.add_argument(
        "--beam_width", type=int, default=0,
        help="CTC prefix beam search width (0 = greedy)",
    )
    parser.add_argument("--lm_path", type=str, default=None,
                        help="CharNGramLM JSON for shallow fusion")
    # None sentinels: both knobs only act inside the LM-fusion decode, so
    # passing them without an LM is an error, not a silent no-op
    parser.add_argument("--lm_weight", type=float, default=None,
                        help="fusion weight (default 0.5; requires --lm_path)")
    parser.add_argument("--token_bonus", type=float, default=None,
                        help="per-char insertion bonus (requires --lm_path)")
    parser.add_argument(
        "--timestamps", action="store_true",
        help="emit word-level start/end times and confidences (greedy "
             "decode only: beam search keeps no frame alignment)",
    )
    parser.add_argument(
        "--stream", action="store_true",
        help="incremental transcription: feed the audio in --stream_chunk_s "
             "pieces and print a JSON line per partial update (greedy only; "
             "the final line equals the offline long-form transcript)",
    )
    parser.add_argument(
        "--stream_chunk_s", type=float, default=2.0,
        help="seconds of audio per simulated stream piece (with --stream)",
    )
    args = parser.parse_args(argv)
    if args.timestamps and args.beam_width > 0:
        parser.error("--timestamps requires greedy decoding (beam_width 0)")
    if args.stream and args.beam_width > 0:
        parser.error("--stream requires greedy decoding (beam_width 0)")

    lm = None
    if args.lm_path:
        if args.beam_width <= 0:
            parser.error("--lm_path requires --beam_width > 0")
        lm = CharNGramLM.load(args.lm_path)
    elif args.lm_weight is not None or args.token_bonus is not None:
        parser.error("--lm_weight/--token_bonus only act with --lm_path")
    model = Wav2Vec2ForCTC.from_pretrained(args.model_dir, device=args.device)
    evaluator = GreedyCTCEvaluator(
        model, beam_width=args.beam_width, lm=lm,
        lm_weight=0.5 if args.lm_weight is None else args.lm_weight,
        token_bonus=0.0 if args.token_bonus is None else args.token_bonus,
    )
    processor = Wav2Vec2Processor(is_tokenizer=False)
    for path in args.files:
        audio, rate = read_sound(path)
        if rate != args.sample_rate:
            raise ValueError(f"{path}: sample rate {rate} != {args.sample_rate}")
        speech = np.asarray(processor(audio), np.float32)
        if args.stream:
            st = StreamingTranscriber(
                evaluator, chunk_samples=args.chunk_samples,
                context_samples=args.context_samples, word_timestamps=args.timestamps,
            )
            piece = max(1, int(args.stream_chunk_s * args.sample_rate))
            last = ""
            for lo in range(0, len(speech), piece):
                partial = st.feed(speech[lo : lo + piece])
                if partial != last:
                    update = {"file": path, "partial": partial,
                              "t": round((lo + piece) / args.sample_rate, 2)}
                    if args.timestamps:
                        update["words"] = st.words  # committed words: live captions
                    print(json.dumps(update), flush=True)
                    last = partial
            final = {"file": path, "transcription": st.finish()}
            if args.timestamps:
                final["words"] = st.words
            print(json.dumps(final))
        elif args.timestamps:
            text, words = evaluator.transcribe_long_segments(
                speech, chunk_samples=args.chunk_samples, context_samples=args.context_samples,
            )
            print(json.dumps({"file": path, "transcription": text, "words": words}))
        else:
            text = evaluator.transcribe_long(
                speech, chunk_samples=args.chunk_samples, context_samples=args.context_samples,
            )
            print(json.dumps({"file": path, "transcription": text}))


if __name__ == "__main__":
    main()

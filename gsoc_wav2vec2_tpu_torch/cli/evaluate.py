"""CLI: greedy-CTC WER evaluation of a model directory on LibriSpeech-style
data (counterpart of `gsoc_wav2vec2_tpu/cli/evaluate.py`, greedy only).

Three modes over the port's `GreedyCTCEvaluator`: `padded` (every batch
padded to `--pad_to`, the reference's fast path), `bucketed` (a handful of
batch shapes, little padding) and `single` (one utterance a forward, the
reference's WER_3 notebook).  `single` rounds each length up to the next
`--round_to` samples; a base-family model takes no attention mask, so that
padding enters attention: `--round_to 1` gives the reference's no-padding
numbers.  The last line printed is one JSON object (`wer`, `num_samples`,
`mode`, `seconds`, and `round_to` in single mode).

Beam search and LM fusion (`--beam_width > 0`, `--lm_path`) are not ported
yet (ROADMAP item 6) and raise.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.evaluate --model_dir <dir> \\
        --data_dir LibriSpeech/test-clean --mode bucketed
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..data.loaders import LibriSpeechDataLoader, LibriSpeechDataLoaderArgs
from ..data.remote import expand_patterns
from ..evaluation import GreedyCTCEvaluator
from ..models.modeling import Wav2Vec2ForCTC
from ..utils.metrics import wer


def _samples(loader: LibriSpeechDataLoader):
    """(waveform, reference text) pairs from a raw corpus or from the tfrecord
    shards training reads (labels are stored tokenised; `group_tokens=False`
    reverses the tokenizer exactly)."""
    it = (loader._tfrecord_samples(loader.tfrecords) if loader.from_tfrecords
          else loader._raw_samples())
    for speech, label in it:
        yield speech, loader.tokenizer.decode(label, group_tokens=False)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("Greedy-CTC WER evaluation (PyTorch port)")
    parser.add_argument("--model_dir", required=True, type=str)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--tfrecords", nargs="*", default=[],
                        help="evaluate tfrecord shards instead of a raw corpus dir "
                             "(glob patterns; local or scheme://)")
    parser.add_argument("--mode", choices=["padded", "bucketed", "single"], default="bucketed")
    parser.add_argument("--beam_width", type=int, default=0,
                        help="prefix beam search: not ported yet (ROADMAP item 6); only 0")
    parser.add_argument("--lm_path", type=str, default=None,
                        help="LM fusion: not ported yet (ROADMAP item 6)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--pad_to", type=int, default=246000)
    parser.add_argument("--limit", type=int, default=0, help="cap sample count")
    parser.add_argument("--round_to", type=int, default=1600,
                        help="single mode: round lengths up to this multiple (samples); "
                             "1 for the reference's no-padding mode")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (bf16 kernels; the default) or cpu (f32 plain path)")
    args = parser.parse_args(argv)

    if bool(args.data_dir) == bool(args.tfrecords):
        parser.error("pass exactly one of --data_dir / --tfrecords")
    if args.beam_width > 0 or args.lm_path:
        raise NotImplementedError(
            "--beam_width / --lm_path: beam search and LM fusion are not ported yet "
            "(ROADMAP.md section 1 item 6); the port decodes greedily")

    model = Wav2Vec2ForCTC.from_pretrained(args.model_dir, device=args.device)
    evaluator = GreedyCTCEvaluator(model)
    if args.tfrecords:
        largs = LibriSpeechDataLoaderArgs(from_tfrecords=True,
                                          tfrecords=expand_patterns(args.tfrecords))
    else:
        largs = LibriSpeechDataLoaderArgs(data_dir=args.data_dir)
    loader = LibriSpeechDataLoader(largs)

    def sample_iter():
        for i, item in enumerate(_samples(loader)):
            if args.limit and i >= args.limit:
                return
            yield item

    start = time.time()
    if args.mode == "padded":
        score, n = evaluator.evaluate_padded(sample_iter(), batch_size=args.batch_size,
                                             pad_to=args.pad_to)
    elif args.mode == "bucketed":
        score, n = evaluator.evaluate_bucketed(sample_iter(), batch_size=args.batch_size)
    else:
        if args.round_to > 1 and not model.config.is_robust:
            print(f"note: --round_to {args.round_to} pads inputs and this base-family model "
                  "takes no attention mask, so padding perturbs attention slightly; pass "
                  "--round_to 1 for the reference's no-padding WER", file=sys.stderr)
        refs, hyps = [], []
        for audio, text in sample_iter():
            true_len = len(audio)
            if args.round_to > 1:
                audio = np.pad(audio, (0, -(-true_len // args.round_to) * args.round_to - true_len))
            hyps.extend(evaluator.predict_batch(audio[None, :], np.asarray([true_len], np.int64)))
            refs.append(text)
        score, n = wer(refs, hyps), len(refs)
    report = {"wer": round(score, 5), "num_samples": n, "mode": args.mode,
              "seconds": round(time.time() - start, 2)}
    if args.mode == "single":
        report["round_to"] = args.round_to
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

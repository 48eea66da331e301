"""CLI: CTC WER evaluation of a model directory on LibriSpeech-style data
(counterpart of `gsoc_wav2vec2_tpu/cli/evaluate.py`).

Three modes over the port's `GreedyCTCEvaluator`: `padded` (every batch
padded to `--pad_to`, the reference's fast path), `bucketed` (a handful of
batch shapes, little padding) and `single` (one utterance a forward, the
reference's WER_3 notebook).  `single` rounds each length up to the next
`--round_to` samples; a base-family model takes no attention mask, so that
padding enters attention: `--round_to 1` gives the reference's no-padding
numbers.  `--beam_width > 0` decodes by prefix beam search, with shallow
fusion of a char n-gram LM read from `--lm_path` or fitted on a corpus's
transcripts (`--lm_fit_dir`).  The last line printed is one JSON object
(`wer`, `num_samples`, `mode`, `seconds`; `round_to` in single mode,
`beam_width` and `lm` where set).  `--sharded` evaluates on several cards:
one process a card under `torchrun`, each reading its slice of the corpus,
the WER aggregated over all of them (`GreedyCTCEvaluator`'s `mesh`); every
rank prints the same report.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.evaluate --model_dir <dir> \\
        --data_dir LibriSpeech/test-clean --mode bucketed
    torchrun --nproc_per_node 8 -m gsoc_wav2vec2_tpu_torch.cli.evaluate --sharded ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..data.loaders import LibriSpeechDataLoader, LibriSpeechDataLoaderArgs
from ..data.remote import expand_patterns
from ..decoding import CharNGramLM
from ..evaluation import GreedyCTCEvaluator
from ..models.modeling import Wav2Vec2ForCTC
from ..parallel import make_mesh, multihost
from ..utils.devices import rank_device
from ..utils.metrics import wer


def _samples(loader: LibriSpeechDataLoader):
    """(waveform, reference text) pairs of the loader's shard, from a raw
    corpus or from the tfrecord shards training reads (labels are stored
    tokenised; `group_tokens=False` reverses the tokenizer exactly).  The JAX
    CLI reads every tfrecord on every process here, so that its sharded WER
    counts each record once a process; the port shards records as its
    loader's stream does."""
    it = (loader.shard_tfrecord_samples(list(loader.tfrecords)) if loader.from_tfrecords
          else loader._raw_samples())
    for speech, label in it:
        yield speech, loader.tokenizer.decode(label, group_tokens=False)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("CTC WER evaluation (PyTorch port)")
    parser.add_argument("--model_dir", required=True, type=str)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--tfrecords", nargs="*", default=[],
                        help="evaluate tfrecord shards instead of a raw corpus dir "
                             "(glob patterns; local or scheme://)")
    parser.add_argument("--mode", choices=["padded", "bucketed", "single"], default="bucketed")
    parser.add_argument("--sharded", action="store_true",
                        help="one process a card (torchrun): each rank evaluates its slice "
                             "of the corpus, the WER is the whole corpus's")
    parser.add_argument("--beam_width", type=int, default=0,
                        help="CTC prefix beam search width (0 = greedy, the reference's decode)")
    parser.add_argument("--lm_path", type=str, default=None,
                        help="CharNGramLM JSON for shallow fusion (see --lm_fit_dir); "
                             "requires --beam_width > 0")
    parser.add_argument("--lm_fit_dir", type=str, default=None,
                        help="fit a char n-gram LM on this corpus's *.trans.txt transcripts "
                             "(saved to --lm_path if given, else used in memory)")
    parser.add_argument("--lm_order", type=int, default=4)
    # None sentinels: both knobs only act inside the LM-fusion decode, so
    # passing them without an LM is an error, not a silent no-op
    parser.add_argument("--lm_weight", type=float, default=None,
                        help="fusion weight (default 0.5; requires an LM)")
    parser.add_argument("--token_bonus", type=float, default=None,
                        help="per-token insertion bonus under LM fusion (requires an LM)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--pad_to", type=int, default=246000)
    parser.add_argument("--limit", type=int, default=0, help="cap sample count")
    parser.add_argument("--round_to", type=int, default=1600,
                        help="single mode: round lengths up to this multiple (samples); "
                             "1 for the reference's no-padding mode")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (bf16 kernels; the default: under torchrun the card "
                             "LOCAL_RANK modulo the cards) or cpu (f32 plain path)")
    args = parser.parse_args(argv)

    if bool(args.data_dir) == bool(args.tfrecords):
        parser.error("pass exactly one of --data_dir / --tfrecords")
    device = rank_device(args.device)
    mesh = None
    if args.sharded:
        if args.mode == "single":
            parser.error("--sharded evaluates in the padded or bucketed mode")
        multihost.initialize(device)
        mesh = make_mesh(model=1)  # every rank on the data axis
        print(f"sharded eval over {mesh.size} processes", file=sys.stderr)

    lm = None
    if args.lm_fit_dir:
        lm = CharNGramLM.fit_from_librispeech(args.lm_fit_dir, args.lm_order)
        if args.lm_path:
            lm.save(args.lm_path)
    elif args.lm_path:
        lm = CharNGramLM.load(args.lm_path)
    if lm is not None and args.beam_width <= 0:
        parser.error("--lm_path/--lm_fit_dir require --beam_width > 0")
    if lm is None and (args.lm_weight is not None or args.token_bonus is not None):
        parser.error("--lm_weight/--token_bonus only act with --lm_path/--lm_fit_dir")
    model = Wav2Vec2ForCTC.from_pretrained(args.model_dir, device=device)
    evaluator = GreedyCTCEvaluator(
        model, beam_width=args.beam_width, lm=lm,
        lm_weight=0.5 if args.lm_weight is None else args.lm_weight,
        token_bonus=0.0 if args.token_bonus is None else args.token_bonus, mesh=mesh,
    )
    if args.tfrecords:
        largs = LibriSpeechDataLoaderArgs(from_tfrecords=True,
                                          tfrecords=expand_patterns(args.tfrecords))
    else:
        largs = LibriSpeechDataLoaderArgs(data_dir=args.data_dir)
    # each rank reads its slice only: the evaluator aggregates the counts
    shard = {} if mesh is None else dict(shard_index=mesh.rank, shard_count=mesh.size)
    loader = LibriSpeechDataLoader(largs, **shard)

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
    if args.beam_width:
        report["beam_width"] = args.beam_width
    if lm is not None:
        report["lm"] = {"order": lm.order, "weight": args.lm_weight,
                        "token_bonus": args.token_bonus}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

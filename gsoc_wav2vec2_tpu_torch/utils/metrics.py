"""Quality metrics (a copy of `gsoc_wav2vec2_tpu/utils/metrics.py`).

The reference computes WER only in notebooks via HuggingFace
`datasets.load_metric("wer")` (the reference's
`notebooks/librispeech_evaluation_WER_3.ipynb`, SURVEY.md §5).  Here it is a
first-class, dependency-free implementation with the same definition:
corpus-level `(S + D + I) / N` over whitespace-tokenised words.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with O(min(len)) memory."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return prev[-1]


def wer(references: List[str], hypotheses: List[str]) -> float:
    """Corpus word error rate: total edit distance / total reference words."""
    if len(references) != len(hypotheses):
        raise ValueError("references and hypotheses must pair up")
    errors = 0
    total = 0
    for ref, hyp in zip(references, hypotheses):
        ref_words = ref.split()
        errors += edit_distance(ref_words, hyp.split())
        total += len(ref_words)
    if total == 0:
        raise ValueError("empty reference corpus")
    return errors / total


def cer(references: List[str], hypotheses: List[str]) -> float:
    """Corpus character error rate."""
    errors = 0
    total = 0
    for ref, hyp in zip(references, hypotheses):
        errors += edit_distance(list(ref), list(hyp))
        total += len(ref)
    if total == 0:
        raise ValueError("empty reference corpus")
    return errors / total


def wer_details(ref: str, hyp: str) -> Tuple[int, int]:
    """(errors, ref_word_count) for a single pair."""
    ref_words = ref.split()
    return edit_distance(ref_words, hyp.split()), len(ref_words)

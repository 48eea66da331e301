"""Text tokenizer + waveform feature extractor (a copy of
`gsoc_wav2vec2_tpu/data/processor.py` whose normaliser takes numpy or torch).

Behavioural clone of the reference `Wav2Vec2Processor`
(the reference's `src/wav2vec2/processor.py`): a 32-entry character
vocabulary, uppercase/strip tokenisation, greedy-CTC duplicate collapse on
decode, and per-sample zero-mean/unit-variance waveform normalisation.

The vocabulary is embedded (identical to the reference's `data/vocab.json`)
so no network fetch is ever needed; a `vocab_path` can still override it.
"""

from __future__ import annotations

import json
import re
from itertools import groupby
from typing import List, Union

import numpy as np
import torch

# Identical mapping to the reference `data/vocab.json` — this 32-symbol
# inventory is the CTC output contract (`<pad>` doubles as the CTC blank).
VOCAB = {
    "<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
    "E": 5, "T": 6, "A": 7, "O": 8, "N": 9, "I": 10, "H": 11, "S": 12,
    "R": 13, "D": 14, "L": 15, "U": 16, "M": 17, "W": 18, "C": 19, "F": 20,
    "G": 21, "Y": 22, "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28,
    "J": 29, "Q": 30, "Z": 31,
}


class Wav2Vec2Processor:
    """Dual-mode processor: tokenizer (`is_tokenizer=True`) or
    waveform feature extractor (`is_tokenizer=False`).

    Reference `processor.py:10-106`.
    """

    def __init__(
        self,
        is_tokenizer: bool,
        do_normalize: bool = True,
        vocab_path: str = None,
    ):
        self.is_tokenizer = is_tokenizer
        self.do_normalize = do_normalize
        self.vocab_path = vocab_path

        if self.is_tokenizer:
            self.token_to_id_mapping = self.get_vocab()
            self.id_to_token_mapping = {
                v: k for k, v in self.token_to_id_mapping.items()
            }
            self.unk_token = "<unk>"
            self.unk_id = self.token_to_id_mapping[self.unk_token]

            self.delimiter_token = "|"
            self.delimiter_id = self.token_to_id_mapping[self.delimiter_token]

            special_tokens = ["<pad>"]
            self.special_ids = [self.token_to_id_mapping[k] for k in special_tokens]

    def get_vocab(self) -> dict:
        if self.vocab_path is not None:
            # fail loudly on a typo'd path — silently falling back to the
            # embedded vocab would train/decode with the wrong symbol table
            # (the reference also failed loudly, `processor.py:36-50`)
            with open(self.vocab_path, "r") as f:
                return json.load(f)
        return dict(VOCAB)

    def __call__(self, input_values):
        """Tokenizer mode: str -> List[int].  Feature-extractor mode:
        waveform array -> normalised waveform (reference `processor.py:52-69`).
        """
        if self.is_tokenizer:
            tokens = self._tokenize(input_values)
            return [self.token_to_id_mapping.get(k, self.unk_id) for k in tokens]
        if self.do_normalize:
            return self._normalize(input_values)
        return input_values

    def decode(
        self,
        input_ids: Union[List[int], np.ndarray],
        skip_special_tokens: bool = True,
        group_tokens: bool = True,
    ) -> str:
        """Greedy-CTC decode: collapse repeats, drop `<pad>`, `|` -> space.

        Reference `processor.py:71-89`.
        """
        input_ids = [int(i) for i in input_ids]
        if group_tokens:
            input_ids = [t[0] for t in groupby(input_ids)]
        if skip_special_tokens:
            input_ids = [k for k in input_ids if k not in self.special_ids]
        tokens = [self.id_to_token_mapping.get(k, self.unk_token) for k in input_ids]
        tokens = [k if k != self.delimiter_token else " " for k in tokens]
        return "".join(tokens).strip()

    def _tokenize(self, string: str) -> List[str]:
        # `-` -> space, strip [^A-Z' ], space -> `|`
        # (reference `processor.py:91-94`)
        string = re.sub("-", " ", string)
        string = re.sub("[^A-Z' ]", "", string.upper())
        return list(string.replace(" ", self.delimiter_token))

    def _normalize(self, x):
        """Per-sample zero-mean unit-variance over the time axis.

        `(x - mean) / sqrt(var + 1e-5)` with population variance, then
        squeeze — reference `processor.py:101-106`.  Accepts numpy arrays
        or torch tensors; runs in whichever library the input lives in.
        """
        if isinstance(x, torch.Tensor):
            mean = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, keepdim=True, unbiased=False)
            return torch.squeeze((x - mean) / torch.sqrt(var + 1e-5))
        x = np.asarray(x)
        mean = np.mean(x, axis=-1, keepdims=True)
        var = np.var(x, axis=-1, keepdims=True)
        return np.squeeze((x - mean) / np.sqrt(var + 1e-5))

"""Host-side data pipeline: LibriSpeech / TIMIT / TFRecord loaders (the
port's copy of `gsoc_wav2vec2_tpu/data/loaders.py`, numpy only: for the same
files and seed its batches are bit-equal to the JAX package's).

The reference's tf.data pipeline (`src/data_utils.py`), rebuilt without the
TF runtime:

  * audio decode + TFRecord parsing via the native C++ library
    (`native_io.py`) instead of soundfile / tf.audio / tf.data;
  * truncate-to-maxlen then pad to fixed `(audio_maxlen, labels_maxlen)`
    shapes (one batch shape per bucket; the reference used `padded_batch`,
    `data_utils.py:62-78`);
  * seeded shuffling that actually happens — the reference's
    `dataset.shuffle(...)` discarded its return value
    (`data_utils.py:59-60`), a no-op it trained with;
  * per-host sharding (`shard_index/shard_count`) — the reference relied
    on every host reading the same GCS files;
  * background-thread prefetch (the tf.data `prefetch(AUTOTUNE)` analog).

Loader args keep the reference's field names and defaults
(`data_utils.py:94-140`).  Batches stay numpy; the trainer moves them to the
card.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import native_io
from .processor import Wav2Vec2Processor

SPEECH_DTYPE = np.float32
LABEL_DTYPE = np.int32


def find_files(data_dir: str, suffix: str) -> List[str]:
    """Recursively collect files ending in `suffix` (reference
    `data_utils.py:80-91`), sorted for determinism.  Remote (`scheme://`)
    directories walk through fsspec."""
    from . import remote

    if remote.is_remote_path(data_dir):
        return remote.find_files_remote(data_dir, suffix)
    found = []
    for root, _dirs, files in os.walk(data_dir):
        for f in files:
            if f.endswith(suffix):
                found.append(os.path.abspath(os.path.join(root, f)))
    return sorted(found)


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` in a daemon thread, keeping `depth` items ready.

    Worker exceptions re-raise in the consumer — a swallowed producer error
    must not masquerade as an empty dataset.  When the consumer abandons the
    generator early (e.g. `--limit` evaluation), the `stop` event unblocks
    the producer's `q.put` so the thread, file handles, and buffered batches
    are released instead of pinned for the process lifetime.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    _SENTINEL = object()
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    getattr(iterator, "close", lambda: None)()
                    return
            q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            if not stop.is_set():
                q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


@dataclass
class LibriSpeechDataLoaderArgs:
    """Reference `data_utils.py:94-121` (same fields & defaults)."""

    from_tfrecords: bool = False
    tfrecords: Optional[List[str]] = None
    data_dir: Optional[str] = "../data/LibriSpeech/test-clean"

    batch_size: int = 16
    buffer_size: int = 10000

    audio_maxlen: int = 400000
    audio_pad_id: int = 0

    labels_maxlen: int = 128
    labels_pad_id: int = 0

    # bucketed batching (absent in the reference, which
    # truncates everything to audio_maxlen — `data_utils.py:75-78`): sorted
    # audio lengths; each sample pads to the smallest bucket that fits it,
    # one train-step shape per bucket.  Samples longer than the
    # largest bucket truncate to it (so set the top bucket to the true
    # corpus maximum to train without truncation).  None = fixed-shape mode.
    bucket_boundaries: Optional[List[int]] = None

    def __post_init__(self):
        if self.from_tfrecords:
            self.data_dir = None
            assert self.tfrecords, "You must specify `tfrecords` when `from_tfrecords=True`."
        else:
            self.tfrecords = None
            assert self.data_dir, "You must specify `data_dir` when `from_tfrecords=False`."


@dataclass
class TimitDataLoaderArgs:
    """Reference `data_utils.py:124-140`."""

    data_dir: str = "../data/timit/data/TRAIN"
    batch_size: int = 16
    buffer_size: int = 10000
    audio_maxlen: int = 400000
    audio_pad_id: int = 0
    labels_maxlen: int = 128
    labels_pad_id: int = 0


class CommonDataLoader:
    """Shuffle → truncate → pad → batch → prefetch (reference
    `CommonDataLoader.batchify`, `data_utils.py:52-78`)."""

    def __init__(
        self,
        batch_size: int,
        buffer_size: int,
        audio_pad_id,
        labels_pad_id: int,
        audio_maxlen: int,
        labels_maxlen: int,
        shard_index: int = 0,
        shard_count: int = 1,
        bucket_boundaries: Optional[List[int]] = None,
    ):
        self.batch_size = batch_size
        self.buffer_size = buffer_size
        self.audio_pad_id = float(audio_pad_id)
        self.labels_pad_id = labels_pad_id
        self.audio_maxlen = audio_maxlen
        self.labels_maxlen = labels_maxlen
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.bucket_boundaries = sorted(bucket_boundaries) if bucket_boundaries else None
        self.processor = Wav2Vec2Processor(is_tokenizer=False)
        self.tokenizer = Wav2Vec2Processor(is_tokenizer=True)

    # -- batching ---------------------------------------------------------

    def _pad_batch(self, samples, audio_len: Optional[int] = None) -> dict:
        b = len(samples)
        audio_len = self.audio_maxlen if audio_len is None else audio_len
        speech = np.full((b, audio_len), self.audio_pad_id, SPEECH_DTYPE)
        labels = np.full((b, self.labels_maxlen), self.labels_pad_id, LABEL_DTYPE)
        attention_mask = np.zeros((b, audio_len), SPEECH_DTYPE)
        for i, (s, l) in enumerate(samples):
            s = s[:audio_len]
            l = l[: self.labels_maxlen]
            speech[i, : len(s)] = s
            labels[i, : len(l)] = l
            attention_mask[i, : len(s)] = 1.0
        return {"speech": speech, "labels": labels, "attention_mask": attention_mask}

    def repad_batch(self, batch: dict, audio_len: int) -> dict:
        """Extend an already-padded batch's audio axis to `audio_len`
        (pad-id speech, zero mask; labels untouched).

        A multi-host bucket consensus uses this to bring every host's next
        batch to the globally agreed shape.  Semantically the sample just landed in a larger bucket — masks and
        length-aware loss already keep bucket padding out of the gradient.
        """
        cur = int(batch["speech"].shape[1])
        if cur == audio_len:
            return batch
        if cur > audio_len:
            raise ValueError(
                f"consensus length {audio_len} below batch length {cur}"
            )
        pad = ((0, 0), (0, audio_len - cur))
        out = dict(batch)
        out["speech"] = np.pad(
            batch["speech"], pad, constant_values=self.audio_pad_id
        ).astype(SPEECH_DTYPE)
        if "attention_mask" in batch:
            out["attention_mask"] = np.pad(batch["attention_mask"], pad).astype(
                SPEECH_DTYPE
            )
        return out

    def _shuffled(self, sample_iter, seed: Optional[int]):
        """Reservoir shuffle (the behaviour the reference *intended* at
        `data_utils.py:59-60` — its call was a no-op); `seed=None` streams
        straight through."""
        if seed is None:
            yield from sample_iter
            return
        rng = np.random.default_rng(seed)
        pool: list = []
        for sample in sample_iter:
            if len(pool) < self.buffer_size:
                pool.append(sample)
                continue
            j = int(rng.integers(0, len(pool)))
            pool[j], sample = sample, pool[j]
            yield sample
        rng.shuffle(pool)
        yield from pool

    def _fixed_batches(self, stream, drop_remainder: bool):
        buf: list = []
        for sample in stream:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self._pad_batch(buf)
                buf = []
        if buf and not drop_remainder:
            yield self._pad_batch(buf)

    def _bucket_batches(self, stream, drop_remainder: bool):
        """One pool per length bucket; a batch is emitted (padded to its
        bucket's length) whenever a pool fills.  2-4 buckets = 2-4
        step shapes, padding bounded by the bucket spacing — the capability
        upgrade over the reference's truncate-to-one-shape training
        (`data_utils.py:75-78`)."""
        buckets = self.bucket_boundaries
        pools = {b: [] for b in buckets}
        for sample in stream:
            length = len(sample[0])
            b = next((bb for bb in buckets if length <= bb), buckets[-1])
            pools[b].append(sample)
            if len(pools[b]) == self.batch_size:
                yield self._pad_batch(pools[b], audio_len=b)
                pools[b] = []
        if not drop_remainder:
            for b in buckets:
                if pools[b]:
                    yield self._pad_batch(pools[b], audio_len=b)

    def batchify(
        self,
        sample_iter: Iterator[Tuple[np.ndarray, np.ndarray]],
        seed: Optional[int] = None,
        drop_remainder: bool = True,
    ) -> Iterator[dict]:
        """Yield padded batches: fixed `(batch, audio_maxlen)` shape, or
        per-bucket shapes when `bucket_boundaries` is set."""
        stream = self._shuffled(sample_iter, seed)
        gen = (
            self._bucket_batches(stream, drop_remainder)
            if self.bucket_boundaries
            else self._fixed_batches(stream, drop_remainder)
        )
        return _prefetch(gen)


class LibriSpeechDataLoader(CommonDataLoader):
    """LibriSpeech loader: TFRecord shards or raw `.flac` + transcript dirs.

    Reference `data_utils.py:138-263`.  `__call__(seed, drop_remainder)`
    yields dict batches of fixed shape.
    """

    def __init__(
        self,
        args: LibriSpeechDataLoaderArgs,
        required_sample_rate: int = 16000,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        super().__init__(
            args.batch_size,
            args.buffer_size,
            args.audio_pad_id,
            args.labels_pad_id,
            args.audio_maxlen,
            args.labels_maxlen,
            shard_index,
            shard_count,
            bucket_boundaries=args.bucket_boundaries,
        )
        self.from_tfrecords = args.from_tfrecords
        self.tfrecords = args.tfrecords
        self.data_dir = args.data_dir
        self.required_sample_rate = required_sample_rate
        self._num_samples: Optional[int] = None
        self._pairs_cache: Optional[list] = None

    def __call__(self, seed: Optional[int] = None, drop_remainder: bool = True):
        if self.from_tfrecords:
            files = list(self.tfrecords)
            if seed is not None:
                np.random.default_rng(seed).shuffle(files)
            samples = self.shard_tfrecord_samples(files)
        else:
            samples = self._raw_samples()
        return self.batchify(samples, seed=seed, drop_remainder=drop_remainder)

    def shard_tfrecord_samples(self, files):
        """This shard's records of `files`: whole files per shard when there
        are at least as many files as shards, per-record striding otherwise."""
        if self.shard_count > 1 and len(files) >= self.shard_count:
            return self._tfrecord_samples(files[self.shard_index :: self.shard_count])
        if self.shard_count > 1:
            return (s for i, s in enumerate(self._tfrecord_samples(files))
                    if i % self.shard_count == self.shard_index)
        return self._tfrecord_samples(files)

    @staticmethod
    def _tfrecord_samples(files):
        from . import remote

        for path in files:
            yield from remote.read_tfrecords_any(path)

    def _collect_transcripts(self) -> dict:
        """`file_id -> text` from all `.txt` files (reference
        `data_utils.py:236-260`).

        Intentional divergence: the reference requires `len(parts) > 2`,
        silently dropping single-word utterances; we accept any line with a
        file id and at least one word.
        """
        from . import remote

        texts = {}
        for path in find_files(self.data_dir, ".txt"):
            with remote.open_text(path) as f:
                for line in f.read().split("\n"):
                    parts = line.split()
                    if len(parts) >= 2:
                        texts[parts[0]] = " ".join(parts[1:])
        return texts

    def _matched_files(self):
        if self._pairs_cache is not None:
            return self._pairs_cache
        flac_paths = find_files(self.data_dir, ".flac")
        texts = self._collect_transcripts()
        pairs = []
        for path in flac_paths:
            file_id = os.path.basename(path)[: -len(".flac")]
            text = texts.pop(file_id, None)
            if text is not None:
                pairs.append((path, text))
        discarded = len(flac_paths) - len(pairs)
        print(f"DISCARDING {discarded} samples")
        print(f"LOADED {len(pairs)} FILES FROM {self.data_dir}")
        self._num_samples = len(pairs)
        if self.shard_count > 1:
            pairs = pairs[self.shard_index :: self.shard_count]
        # cache the (path, text) list: the walk is deterministic (sorted)
        # and per-epoch randomisation happens downstream in the reservoir
        # shuffle, so re-walking every epoch buys nothing
        self._pairs_cache = pairs
        return pairs

    def num_batches(self, drop_remainder: bool = True) -> Optional[int]:
        """This host's batch count per epoch, or None when it cannot be
        known without reading the data (tfrecord shards).

        Raw corpora: every matched (flac, transcript) pair yields exactly
        one sample, so the count follows from the file walk alone (what lets
        hosts agree on a count once per epoch).
        """
        if self.from_tfrecords:
            return None
        if self.bucket_boundaries:
            # per-bucket fill order depends on the length distribution
            return None
        n = len(self._matched_files())
        if drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    # files decoded per native thread-pool call
    _DECODE_CHUNK = 16

    def _raw_samples(self):
        from . import remote

        pairs = self._matched_files()
        for start in range(0, len(pairs), self._DECODE_CHUNK):
            chunk = pairs[start : start + self._DECODE_CHUNK]
            if chunk and remote.is_remote_path(chunk[0][0]):
                # remote objects: parallel GETs (fs.cat), then concurrent
                # in-memory decodes (ctypes releases the GIL) — keeps the
                # local branch's "fast path" property over the network
                from concurrent.futures import ThreadPoolExecutor

                paths = [p for p, _ in chunk]
                blobs = remote.fetch_bytes_batch(paths)
                with ThreadPoolExecutor(max_workers=8) as pool:
                    decoded = list(
                        pool.map(
                            lambda pb: native_io.decode_flac_bytes(
                                pb[1], name=pb[0]
                            ),
                            zip(paths, blobs),
                        )
                    )
            else:
                # C++ thread pool decodes the chunk concurrently (GIL released)
                decoded = native_io.decode_flac_batch([p for p, _ in chunk])
            for (path, text), (audio, rate) in zip(chunk, decoded):
                if rate != self.required_sample_rate:
                    raise ValueError(
                        f"sample rate (={rate}) of your files must be "
                        f"{self.required_sample_rate}"
                    )
                speech = np.asarray(self.processor(audio), SPEECH_DTYPE)
                label = np.asarray(self.tokenizer(text), LABEL_DTYPE)
                yield speech, label

    def __len__(self):
        if self._num_samples is None:
            raise NotImplementedError
        return self._num_samples


class TimitDataLoader(CommonDataLoader):
    """TIMIT loader: paired `.WAV`/`.TXT` (reference `data_utils.py:266-324`)."""

    def __init__(self, args: TimitDataLoaderArgs, shard_index: int = 0, shard_count: int = 1):
        super().__init__(
            args.batch_size,
            args.buffer_size,
            args.audio_pad_id,
            args.labels_pad_id,
            args.audio_maxlen,
            args.labels_maxlen,
            shard_index,
            shard_count,
        )
        self.data_dir = args.data_dir
        self.wav_ext = ".WAV"
        self.txt_ext = ".TXT"

    def _samples(self):
        wav_files = {p[: -len(self.wav_ext)] for p in find_files(self.data_dir, self.wav_ext)}
        txt_files = {p[: -len(self.txt_ext)] for p in find_files(self.data_dir, self.txt_ext)}
        stems = sorted(wav_files & txt_files)
        print(f"found {len(stems)} samples in {self.data_dir}")
        if self.shard_count > 1:
            stems = stems[self.shard_index :: self.shard_count]
        for stem in stems:
            audio, _rate = native_io.decode_wav(stem + self.wav_ext)
            speech = np.asarray(self.processor(audio), SPEECH_DTYPE)
            # TIMIT transcript lines start with two sample offsets
            # (reference `read_timit_txt`, `data_utils.py:312-315`)
            with open(stem + self.txt_ext) as f:
                text = " ".join(f.read().split()[2:])
            label = np.asarray(self.tokenizer(text), LABEL_DTYPE)
            yield speech, label

    def __call__(self, seed: Optional[int] = None, drop_remainder: bool = True):
        return self.batchify(self._samples(), seed=seed, drop_remainder=drop_remainder)

"""CLI: shard a raw LibriSpeech directory into TFRecord files (counterpart of
`gsoc_wav2vec2_tpu/cli/make_tfrecords.py`).

The reference's `src/make_tfrecords.py` (same flags, same round-robin
sharding, same length-stats report), writing through the port's native C++
TFRecord codec: the shards are byte-format-compatible with tf.data, with
shards the reference produced and with the JAX package's.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.make_tfrecords \
        --data_dir ../data/LibriSpeech/dev-clean -d dev-clean -n 4
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.loaders import LibriSpeechDataLoader, LibriSpeechDataLoaderArgs
from ..data.native_io import TFRecordWriter


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "CLI to convert a .flac dataset into .tfrecord shards"
    )
    parser.add_argument("--data_dir", default="../data/LibriSpeech/dev-clean", type=str)
    parser.add_argument("-d", "--tfrecord_dir", default="dev-clean", type=str)
    parser.add_argument("-n", "--num_shards", default=1, type=int)
    args = parser.parse_args(argv)

    os.makedirs(args.tfrecord_dir, exist_ok=True)
    loader = LibriSpeechDataLoader(LibriSpeechDataLoaderArgs(data_dir=args.data_dir))
    samples = loader._raw_samples()

    base = os.path.basename(os.path.normpath(args.tfrecord_dir))
    file_names = [
        os.path.join(args.tfrecord_dir, f"{base}-{i}.tfrecord")
        for i in range(args.num_shards)
    ]
    writers = [TFRecordWriter(name) for name in file_names]

    speech_stats, label_stats = [], []
    count = 0
    shard = 0
    # fill shards evenly: num_samples is only known after the walk, so
    # round-robin per record (keeps shards within one record of each other)
    for speech, label in samples:
        writers[shard].write(speech, label)
        shard = (shard + 1) % args.num_shards
        speech_stats.append(len(speech))
        label_stats.append(len(label))
        count += 1
        if count % 500 == 0:
            print(f"wrote {count} records")
    for w in writers:
        w.close()

    if speech_stats:
        print(
            f"speech length: min={min(speech_stats)} "
            f"mean={np.mean(speech_stats):.1f} max={max(speech_stats)}"
        )
        print(
            f"label length:  min={min(label_stats)} "
            f"mean={np.mean(label_stats):.1f} max={max(label_stats)}"
        )
    print(f"wrote {count} records into {len(file_names)} shard(s): {file_names}")


if __name__ == "__main__":
    main()

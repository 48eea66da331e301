"""The port's data plane against the JAX package's, on the CPU.

`tests/test_native_io.py` and `tests/test_dataloader.py` through the port:
the native codec (the port's own build of its own copy of `w2v2io.cc`, byte
for byte the JAX package's source) read against the JAX package's reader and
TensorFlow's, FLAC from `tests/flac_encoder.py` in every subframe and stereo
kind; the loaders' batches bit-equal to the JAX package's for the same files
and seed (fixed and bucketed batches, tfrecord and raw sources, per-host
shards, `repad_batch`); `cli.make_tfrecords`; `memory://` shards through
fsspec.
"""

import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from flac_encoder import encode_flac

from gsoc_wav2vec2_tpu.data import loaders as jax_loaders
from gsoc_wav2vec2_tpu.data import native_io as jax_native_io
from gsoc_wav2vec2_tpu_torch.data import loaders, native_io, remote
from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TRANSCRIPTS = [
    "HELLO WORLD",
    "SHE HAD YOUR DARK SUIT",
    "DON'T ASK ME TO CARRY AN OILY RAG",
    "SPEECH RECOGNITION ON TPUS",
    "A",
    "SIX SAMPLES IN ALL",
]


def test_codec_source_is_the_jax_packages_byte_for_byte():
    ours = ROOT / "gsoc_wav2vec2_tpu_torch" / "data" / "native" / "w2v2io.cc"
    theirs = ROOT / "gsoc_wav2vec2_tpu" / "data" / "native" / "w2v2io.cc"
    assert ours.read_bytes() == theirs.read_bytes()


def test_library_builds_into_the_ports_build_directory():
    path = native_io.build()
    assert path.parent == ROOT / "gsoc_wav2vec2_tpu_torch" / "_build"
    assert path == native_io.library_path() and path.is_file()
    assert native_io.get_lib()._name == str(path)


def test_concurrent_first_builds_in_one_process_all_succeed(tmp_path, monkeypatch):
    """Threads of one process that reach a codec not yet built (a server's
    handlers decoding their first requests at once) all get the library: the
    build is serialised, so no thread renames another's half-written file or
    finds its own temporary gone."""
    import ctypes
    import threading

    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "_build")
    results, errors = [], []

    def first_use():
        try:
            results.append(native_io.build())
        except Exception as e:  # noqa: BLE001 - every thread's failure is the finding
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(set(results)) == 1 and results[0].parent == tmp_path / "_build"
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [results[0].name]
    ctypes.CDLL(str(results[0]))


# --- the codec -------------------------------------------------------------


def _random_sample(rng, n=1000, u=12):
    return rng.standard_normal(n).astype(np.float32), rng.integers(0, 32, size=u).astype(np.int32)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfrecord_round_trip_across_the_two_codecs(tmp_path, writer):
    rng = np.random.default_rng(0)
    samples = [_random_sample(rng, n, u) for n, u in [(1000, 12), (5, 1), (40000, 128), (0, 0)]]
    path = str(tmp_path / "a.tfrecord")
    write_mod = native_io if writer == "port" else jax_native_io
    with write_mod.TFRecordWriter(path) as w:
        for speech, label in samples:
            w.write(speech, label)
    for read in (native_io.read_tfrecords, jax_native_io.read_tfrecords):
        got = list(read(path))
        assert len(got) == len(samples)
        for (s0, l0), (s1, l1) in zip(samples, got):
            assert s1.dtype == np.float32 and l1.dtype == np.int32
            np.testing.assert_array_equal(s0, s1)
            np.testing.assert_array_equal(l0, l1)
    buf = open(path, "rb").read()
    assert [s.tolist() for s, _ in native_io.read_tfrecords_bytes(buf)] == \
        [s.tolist() for s, _ in jax_native_io.read_tfrecords_bytes(buf)]
    port_path = str(tmp_path / "b.tfrecord")
    with native_io.TFRecordWriter(port_path) as w:
        for speech, label in samples:
            w.write(speech, label)
    assert open(port_path, "rb").read() == buf


def test_tfrecord_native_write_tf_read_and_back(tmp_path):
    """The reference's own tf.data parse of a port shard, and a shard written
    the reference's way through tf.io read by the port."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(1)
    speech, label = _random_sample(rng)
    path = str(tmp_path / "b.tfrecord")
    with native_io.TFRecordWriter(path) as w:
        w.write(speech, label)
    desc = {"speech": tf.io.FixedLenFeature((), tf.string),
            "label": tf.io.FixedLenFeature((), tf.string)}
    for record in tf.data.TFRecordDataset([path]):
        parsed = tf.io.parse_single_example(record, desc)
        np.testing.assert_array_equal(speech, tf.io.parse_tensor(parsed["speech"], tf.float32).numpy())
        np.testing.assert_array_equal(label, tf.io.parse_tensor(parsed["label"], tf.int32).numpy())

    path = str(tmp_path / "c.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        feature = {
            "speech": tf.train.Feature(bytes_list=tf.train.BytesList(
                value=[tf.io.serialize_tensor(tf.constant(speech)).numpy()])),
            "label": tf.train.Feature(bytes_list=tf.train.BytesList(
                value=[tf.io.serialize_tensor(tf.constant(label)).numpy()])),
        }
        w.write(tf.train.Example(features=tf.train.Features(feature=feature)).SerializeToString())
    [(s, l)] = list(native_io.read_tfrecords(path))
    np.testing.assert_array_equal(s, speech)
    np.testing.assert_array_equal(l, label)


def test_tfrecord_corruption_and_missing_files_raise(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "d.tfrecord")
    with native_io.TFRecordWriter(path) as w:
        w.write(*_random_sample(rng))
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF  # a payload byte: the CRC catches it
    open(path, "wb").write(bytes(raw))
    with pytest.raises(OSError, match="corrupt"):
        list(native_io.read_tfrecords(path))
    with pytest.raises(OSError):
        list(native_io.read_tfrecords(str(tmp_path / "missing.tfrecord")))
    with pytest.raises(OSError):
        native_io.TFRecordWriter(str(tmp_path / "no" / "such" / "dir.tfrecord"))


def _write_wav(path, pcm16, rate=16000, channels=1):
    data = np.asarray(pcm16).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate, rate * 2 * channels,
                                      2 * channels, 16))
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_matches_the_jax_reader(tmp_path, channels):
    rng = np.random.default_rng(4)
    pcm = rng.integers(-32768, 32767, size=(3001, channels))
    path = str(tmp_path / "a.wav")
    _write_wav(path, pcm, rate=8000, channels=channels)
    got, rate = native_io.decode_wav(path)
    want, want_rate = jax_native_io.decode_wav(path)
    assert rate == want_rate == 8000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pcm[:, 0] / 32768.0)
    buf_got, _ = native_io.decode_wav_bytes(open(path, "rb").read())
    np.testing.assert_array_equal(buf_got, got)
    upper = tmp_path / "B.WAV"
    upper.write_bytes(open(path, "rb").read())
    np.testing.assert_array_equal(native_io.read_sound(str(upper))[0], got)


def _int16_signal(rng, n):
    t = np.arange(n)
    sig = 3000 * np.sin(t / 7.0) + 500 * np.sin(t / 3.1) + rng.integers(-40, 40, n)
    return np.clip(sig, -32768, 32767).astype(np.int64)


@pytest.mark.parametrize(
    "kind,kw",
    [
        ("verbatim", {}),
        ("constant", {}),
        ("fixed", {"order": 0, "rice_param": 14}),
        ("fixed", {"order": 1, "rice_param": 8}),
        ("fixed", {"order": 2, "rice_param": 6}),
        ("fixed", {"order": 3, "rice_param": 6}),
        ("fixed", {"order": 4, "rice_param": 6}),
        ("fixed", {"order": 2, "rice_param": 6, "partition_order": 2}),
        ("fixed", {"order": 2, "escape_bits": 17}),
        ("lpc", {"order": 2, "lpc_coefs": [3, -2], "lpc_shift": 1, "rice_param": 7}),
        ("lpc", {"order": 5, "lpc_coefs": [2, 1, -1, 1, -1], "lpc_shift": 2,
                 "rice_param": 9, "lpc_precision": 10}),
    ],
)
def test_flac_mono_subframe_kinds(tmp_path, kind, kw):
    rng = np.random.default_rng(4)
    n = 4096 + 1500  # a short trailing frame
    sig = np.full(n, 123, np.int64) if kind == "constant" else _int16_signal(rng, n)
    path = str(tmp_path / f"{kind}.flac")
    with open(path, "wb") as f:
        f.write(encode_flac(sig, subframe_kind=kind, **kw))
    audio, rate = native_io.decode_flac(path)
    assert rate == 16000
    np.testing.assert_array_equal(np.round(audio * 32768.0).astype(np.int64), sig)
    np.testing.assert_array_equal(audio, jax_native_io.decode_flac(path)[0])


@pytest.mark.parametrize("assignment", ["independent", "left_side", "right_side", "mid_side"])
def test_flac_stereo_assignments(tmp_path, assignment):
    rng = np.random.default_rng(5)
    left = _int16_signal(rng, 2048)
    right = np.clip(left // 2 + rng.integers(-100, 100, 2048), -32768, 32767)
    data = encode_flac(np.stack([left, right], axis=1), blocksize=1024, subframe_kind="fixed",
                       order=2, rice_param=7, channel_assignment=assignment)
    audio, _ = native_io.decode_flac_bytes(data)
    np.testing.assert_array_equal(np.round(audio * 32768.0).astype(np.int64), left)


def test_flac_garbage_and_batch_decode(tmp_path):
    bad = str(tmp_path / "bad.flac")
    with open(bad, "wb") as f:
        f.write(b"not a flac stream at all")
    with pytest.raises(OSError):
        native_io.decode_flac(bad)
    with pytest.raises(OSError):
        native_io.decode_flac_bytes(b"junk")
    rng = np.random.default_rng(9)
    paths = []
    for i in range(12):
        p = str(tmp_path / f"s{i}.flac")
        with open(p, "wb") as f:
            f.write(encode_flac(_int16_signal(rng, 3000 + 257 * i), subframe_kind="fixed",
                                order=2, rice_param=7))
        paths.append(p)
    batch = native_io.decode_flac_batch(paths, num_threads=4)
    assert len(batch) == len(paths)
    for p, (audio, rate) in zip(paths, batch):
        want, want_rate = jax_native_io.decode_flac(p)
        np.testing.assert_array_equal(audio, want)
        assert rate == want_rate
    with pytest.raises(OSError, match="bad.flac"):
        native_io.decode_flac_batch(paths[:2] + [bad], num_threads=4)
    assert native_io.decode_flac_batch([]) == []


# --- the loaders -----------------------------------------------------------


def _signal(rng, n):
    sig = 2500 * np.sin(np.arange(n) / 9.0) + rng.integers(-50, 50, n)
    return np.clip(sig, -32768, 32767).astype(np.int64)


@pytest.fixture(scope="module")
def librispeech_dir(tmp_path_factory):
    """spk/chap/spk-chap-utt.flac + one spk-chap.trans.txt per chapter, two
    chapters, and an orphan flac with no transcript."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("LibriSpeech")
    for c, chap_id in enumerate(("198", "199")):
        chap = root / "19" / chap_id
        chap.mkdir(parents=True)
        lines = []
        for i, text in enumerate(TRANSCRIPTS[3 * c: 3 * c + 3]):
            file_id = f"19-{chap_id}-{i:04d}"
            (chap / f"{file_id}.flac").write_bytes(encode_flac(
                _signal(rng, 6000 + 1700 * (3 * c + i)), subframe_kind="fixed", order=2,
                rice_param=7))
            lines.append(f"{file_id} {text}")
        (chap / f"19-{chap_id}.trans.txt").write_text("\n".join(lines))
    (root / "19" / "198" / "19-198-9999.flac").write_bytes(
        encode_flac(_signal(rng, 5000), subframe_kind="verbatim"))
    return str(root)


def _both(args_kwargs, **loader_kwargs):
    port = loaders.LibriSpeechDataLoader(loaders.LibriSpeechDataLoaderArgs(**args_kwargs),
                                         **loader_kwargs)
    ref = jax_loaders.LibriSpeechDataLoader(jax_loaders.LibriSpeechDataLoaderArgs(**args_kwargs),
                                            **loader_kwargs)
    return port, ref


def _assert_same_batches(got, want):
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loader_args_keep_the_jax_fields_and_defaults():
    import dataclasses

    for ours, theirs in ((loaders.LibriSpeechDataLoaderArgs, jax_loaders.LibriSpeechDataLoaderArgs),
                         (loaders.TimitDataLoaderArgs, jax_loaders.TimitDataLoaderArgs)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("seed", [None, 0, 3])
@pytest.mark.parametrize("buckets", [None, [9000, 16000]], ids=["fixed", "bucketed"])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_raw_loader_batches_equal_jax(librispeech_dir, seed, buckets, drop_remainder):
    port, ref = _both(dict(data_dir=librispeech_dir, batch_size=2, audio_maxlen=12000,
                           labels_maxlen=64, buffer_size=3, bucket_boundaries=buckets))
    got = list(port(seed=seed, drop_remainder=drop_remainder))
    _assert_same_batches(got, list(ref(seed=seed, drop_remainder=drop_remainder)))
    assert len(port) == len(ref) == 6
    assert port.num_batches(drop_remainder) == ref.num_batches(drop_remainder)


def test_raw_loader_decodes_the_transcripts_and_normalises(librispeech_dir):
    port, _ = _both(dict(data_dir=librispeech_dir, batch_size=3, audio_maxlen=16000,
                         labels_maxlen=64))
    batches = list(port(seed=None, drop_remainder=True))
    assert len(batches) == 2  # 6 matched samples, the orphan discarded
    tok = Wav2Vec2Processor(is_tokenizer=True)
    decoded = [tok.decode(row, group_tokens=False) for b in batches for row in b["labels"]]
    assert sorted(decoded) == sorted(TRANSCRIPTS)
    mask = batches[0]["attention_mask"][0].astype(bool)
    valid = batches[0]["speech"][0][mask]
    assert abs(valid.mean()) < 1e-3 and abs(valid.std() - 1.0) < 1e-2


@pytest.fixture(scope="module")
def shards(librispeech_dir, tmp_path_factory):
    """Three shards written by the port's `cli.make_tfrecords`."""
    from gsoc_wav2vec2_tpu_torch.cli import make_tfrecords

    out = tmp_path_factory.mktemp("shards") / "train"
    make_tfrecords.main(["--data_dir", librispeech_dir, "-d", str(out), "-n", "3"])
    return sorted(str(p) for p in out.iterdir())


def test_make_tfrecords_writes_what_the_jax_cli_writes(librispeech_dir, shards, tmp_path):
    import subprocess
    import sys

    assert [os.path.basename(p) for p in shards] == [f"train-{i}.tfrecord" for i in range(3)]
    ref_dir = tmp_path / "train"
    proc = subprocess.run([sys.executable, "-m", "gsoc_wav2vec2_tpu.cli.make_tfrecords",
                           "--data_dir", librispeech_dir, "-d", str(ref_dir), "-n", "3"],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for p in shards:
        assert open(p, "rb").read() == (ref_dir / os.path.basename(p)).read_bytes()
    assert sum(1 for p in shards for _ in native_io.read_tfrecords(p)) == 6


@pytest.mark.parametrize("seed", [None, 1, 5])
@pytest.mark.parametrize("buckets", [None, [9000, 16000]], ids=["fixed", "bucketed"])
@pytest.mark.parametrize("shard_count", [1, 2, 4], ids=["one_host", "files_per_host", "records_per_host"])
def test_tfrecord_loader_batches_equal_jax(shards, seed, buckets, shard_count):
    """Per-host shards: whole files per host while there are at least as many
    files as hosts, a stride over the records otherwise."""
    for host in range(shard_count):
        port, ref = _both(dict(from_tfrecords=True, tfrecords=shards, batch_size=1,
                               audio_maxlen=12000, labels_maxlen=64, bucket_boundaries=buckets),
                          shard_index=host, shard_count=shard_count)
        _assert_same_batches(list(port(seed=seed, drop_remainder=False)),
                             list(ref(seed=seed, drop_remainder=False)))
        assert port.num_batches() is None


def test_shuffle_shuffles_and_is_seeded(librispeech_dir):
    port, _ = _both(dict(data_dir=librispeech_dir, batch_size=1, audio_maxlen=12000,
                         buffer_size=4))

    def order(seed):
        return [tuple(b["labels"][0][:8]) for b in port(seed=seed)]

    assert order(3) == order(3)
    assert len({tuple(order(s)) for s in range(6)}) > 1


def test_raw_loader_host_shards_partition_the_corpus(librispeech_dir):
    seen = []
    for host in range(2):
        port, ref = _both(dict(data_dir=librispeech_dir, batch_size=1, audio_maxlen=16000,
                               labels_maxlen=64), shard_index=host, shard_count=2)
        got = list(port(seed=2, drop_remainder=True))
        _assert_same_batches(got, list(ref(seed=2, drop_remainder=True)))
        assert port.num_batches() == 3
        seen += [tuple(b["labels"][0]) for b in got]
    assert len(set(seen)) == 6


def _samples(lengths):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(n).astype(np.float32), np.asarray([1, 2, 3], np.int32))
            for n in lengths]


def _common(mod, **kwargs):
    defaults = dict(batch_size=2, buffer_size=8, audio_pad_id=0, labels_pad_id=0,
                    audio_maxlen=1000, labels_maxlen=8)
    defaults.update(kwargs)
    return mod.CommonDataLoader(**defaults)


@pytest.mark.parametrize("lengths,buckets", [
    ([300, 450, 1800, 1500], [500, 2000]),   # past audio_maxlen, kept by its bucket
    ([300, 1800, 400, 450], [500, 2000]),    # remainders
    ([300, 700, 900, 1000, 1200], None),     # fixed: truncate, one remainder
    ([300, 700, 900, 1000], [1000]),         # one bucket is the fixed path
])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batchify_equals_jax(lengths, buckets, drop_remainder):
    for seed in (None, 7):
        got = list(_common(loaders, bucket_boundaries=buckets).batchify(
            iter(_samples(lengths)), seed=seed, drop_remainder=drop_remainder))
        want = list(_common(jax_loaders, bucket_boundaries=buckets).batchify(
            iter(_samples(lengths)), seed=seed, drop_remainder=drop_remainder))
        if not want:
            assert not got
            continue
        _assert_same_batches(got, want)


def test_repad_batch_equals_jax_and_refuses_to_shrink():
    port = _common(loaders, bucket_boundaries=[500, 2000])
    ref = _common(jax_loaders, bucket_boundaries=[500, 2000])
    [batch] = list(port.batchify(iter(_samples([300, 400]))))
    [ref_batch] = list(ref.batchify(iter(_samples([300, 400]))))
    _assert_same_batches([port.repad_batch(batch, 2000)], [ref.repad_batch(ref_batch, 2000)])
    assert port.repad_batch(batch, 500) is batch
    with pytest.raises(ValueError):
        port.repad_batch(batch, 400)


def test_prefetch_reraises_the_producers_error():
    def broken():
        yield 1
        raise OSError("disk gone")

    it = loaders._prefetch(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)


@pytest.fixture(scope="module")
def timit_dir(tmp_path_factory):
    rng = np.random.default_rng(8)
    root = tmp_path_factory.mktemp("timit") / "TRAIN" / "DR1"
    root.mkdir(parents=True)
    for i, text in enumerate(TRANSCRIPTS[:3]):
        stem = root / f"S{i}"
        _write_wav(str(stem) + ".WAV", _signal(rng, 6000))
        with open(str(stem) + ".TXT", "w") as f:
            f.write(f"0 6000 {text}")
    _write_wav(str(root / "ORPHAN.WAV"), _signal(rng, 3000))
    return str(root.parent)


def test_timit_loader_equals_jax(timit_dir):
    for seed in (None, 4):
        args = dict(data_dir=timit_dir, batch_size=2, audio_maxlen=8000, labels_maxlen=64)
        got = list(loaders.TimitDataLoader(loaders.TimitDataLoaderArgs(**args))(
            seed=seed, drop_remainder=False))
        want = list(jax_loaders.TimitDataLoader(jax_loaders.TimitDataLoaderArgs(**args))(
            seed=seed, drop_remainder=False))
        _assert_same_batches(got, want)
    tok = Wav2Vec2Processor(is_tokenizer=True)
    decoded = sorted(tok.decode(r, group_tokens=False) for b in got for r in b["labels"])
    assert decoded == sorted(TRANSCRIPTS[:3])


def test_find_files_equals_jax(librispeech_dir):
    for suffix in (".flac", ".txt"):
        assert loaders.find_files(librispeech_dir, suffix) == \
            jax_loaders.find_files(librispeech_dir, suffix)


@pytest.fixture()
def memfs():
    import fsspec

    fs = fsspec.filesystem("memory")
    yield fs
    for path in list(fs.store):
        try:
            fs.rm(path)
        except FileNotFoundError:
            pass


def test_remote_shards_and_corpus_through_fsspec(memfs, shards, librispeech_dir):
    for p in shards:
        with memfs.open(f"/bucket/{os.path.basename(p)}", "wb") as f:
            f.write(open(p, "rb").read())
    from gsoc_wav2vec2_tpu.data import remote as jax_remote

    patterns = ["memory://bucket/train-*.tfrecord", "/no/such/*.tfrecord"]
    urls = remote.expand_patterns(patterns)
    assert urls == jax_remote.expand_patterns(patterns)
    assert len(urls) == 4 and urls[-1] == patterns[-1]
    port, ref = _both(dict(from_tfrecords=True, tfrecords=urls[:3], batch_size=2,
                           audio_maxlen=12000, labels_maxlen=64))
    _assert_same_batches(list(port(seed=1)), list(ref(seed=1)))
    assert remote.fetch_bytes_batch(urls[:2]) == [open(p, "rb").read() for p in shards[:2]]

    for path in loaders.find_files(librispeech_dir, ""):
        rel = os.path.relpath(path, librispeech_dir)
        with memfs.open(f"/corpus/{rel}", "wb") as f:
            f.write(open(path, "rb").read())
    port, ref = _both(dict(data_dir="memory://corpus", batch_size=2, audio_maxlen=16000,
                           labels_maxlen=64))
    _assert_same_batches(list(port(seed=0)), list(ref(seed=0)))
    local, _ = _both(dict(data_dir=librispeech_dir, batch_size=2, audio_maxlen=16000,
                          labels_maxlen=64))
    _assert_same_batches(list(port(seed=0)), list(local(seed=0)))

"""Remote (object-store) storage: `scheme://` tfrecords, corpora, weights and
checkpoints (counterpart of `gsoc_wav2vec2_tpu/data/remote.py`).

Every `scheme://` path (gs://, s3://, memory://, ...) goes through `fsspec`,
imported only on such a path: the card's machine has no fsspec, and local
paths never need it.  A remote path without fsspec raises `ImportError`
naming it; nothing falls back.

  * `expand_patterns` globs local and remote patterns alike (`glob.glob`
    returns nothing for URLs);
  * shard bytes are fetched whole and parsed by the native TFRecord codec's
    in-memory entry point (`native_io.read_tfrecords_bytes`);
  * `fetch_bytes` / `write_bytes` read and write whole objects, local paths
    included (the weight files and checkpoints use them).
"""

from __future__ import annotations

import glob
from typing import Iterator, List, Tuple

import numpy as np

from . import native_io


def is_remote_path(path: str) -> bool:
    """True for `scheme://...` URLs."""
    return "://" in path


def _fsspec():
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            "a scheme:// path needs the `fsspec` package (and the store's "
            "driver, e.g. gcsfs for gs://), which is not installed"
        ) from e
    return fsspec


def fs_for(url: str):
    """(fsspec filesystem, path within it) of a `scheme://` URL."""
    return _fsspec().core.url_to_fs(url)


def _with_protocol(fs, path: str) -> str:
    proto = fs.protocol if isinstance(fs.protocol, str) else fs.protocol[0]
    if proto in ("file", "local"):
        return path
    return fs.unstrip_protocol(path)


def expand_patterns(patterns: List[str]) -> List[str]:
    """Glob-expand a mixed list of local/remote patterns; a pattern with no
    match is kept verbatim, so that the loader fails naming it."""
    expanded: List[str] = []
    for p in patterns:
        if is_remote_path(p):
            fs, path = fs_for(p)
            matches = sorted(fs.glob(path))
            expanded.extend([_with_protocol(fs, m) for m in matches] if matches else [p])
        else:
            matches = sorted(glob.glob(p))
            expanded.extend(matches if matches else [p])
    return expanded


def fetch_bytes(path: str) -> bytes:
    """The whole content of a local file or a remote object."""
    if is_remote_path(path):
        with _fsspec().open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def write_bytes(url: str, data: bytes) -> None:
    """Write a whole remote object."""
    with _fsspec().open(url, "wb") as f:
        f.write(data)


def fetch_bytes_batch(urls) -> list:
    """Read many remote objects concurrently (one `fs.cat` per store);
    bytes in input order."""
    if not urls:
        return []
    groups: dict = {}  # fs -> (indices, paths)
    for i, u in enumerate(urls):
        fs, path = fs_for(u)
        groups.setdefault(fs, ([], []))
        groups[fs][0].append(i)
        groups[fs][1].append(path)
    results: list = [None] * len(urls)
    for fs, (indices, paths) in groups.items():
        out = fs.cat(paths)
        for i, p in zip(indices, paths):
            results[i] = out[p]
    return results


def read_tfrecords_any(path: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """`native_io.read_tfrecords` for local paths; fetch + parse for URLs."""
    if is_remote_path(path):
        return native_io.read_tfrecords_bytes(fetch_bytes(path), name=path)
    return native_io.read_tfrecords(path)


def find_files_remote(data_dir: str, suffix: str) -> List[str]:
    """Recursive suffix search on a remote directory (fsspec `find`)."""
    fs, path = fs_for(data_dir)
    return sorted(_with_protocol(fs, p) for p in fs.find(path) if p.endswith(suffix))


def open_text(path: str):
    """Text-mode open that understands URLs."""
    if is_remote_path(path):
        return _fsspec().open(path, "r").open()
    return open(path)

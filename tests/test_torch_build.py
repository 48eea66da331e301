"""The kernel build (`ops/kernels/_build.py`) on the CPU, with `find_nvcc`
replaced by a stub compiler that records its calls: two threads of one
process that reach the first build together compile each source once and
link once, and both get the one library.  (Before the build lock they shared
one object directory, keyed by process id, and both wrote it.)"""

import sys
import threading
from pathlib import Path

import torch

from gsoc_wav2vec2_tpu_torch.ops.kernels import _build

torch.set_num_threads(2)


def test_concurrent_first_builds_compile_each_source_once(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "args = sys.argv[1:]\n"
        f"with open({str(log)!r}, 'a') as f:\n"
        "    f.write(' '.join(args) + '\\n')\n"
        "time.sleep(0.3)  # a compile takes a while: the other thread arrives meanwhile\n"
        "open(args[args.index('-o') + 1], 'wb').close()\n"
    )
    stub.chmod(0o755)
    found = []

    def find_nvcc():
        found.append(threading.get_ident())
        return str(stub)

    monkeypatch.setattr(_build, "find_nvcc", find_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    barrier = threading.Barrier(2)
    results, errors = [], []

    def first_use():
        barrier.wait()
        try:
            results.append(_build.build())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    lines = log.read_text().splitlines()
    compiled = sorted(Path(l.split(" -c ")[1].split()[0]).name for l in lines if " -c " in l)
    assert compiled == sorted(src.name for src in _build._sources())
    assert len([l for l in lines if "-shared" in l]) == 1
    assert len(found) == 2  # one compile round, one link
    assert len(results) == 2 and results[0] == results[1] and results[0].is_file()
    # the object directory is gone; a later call reuses the library
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [results[0].name]
    assert _build.build() == results[0] and len(found) == 2

"""`cli.serve --sharded` as two gloo ranks on the CPU: rank 0 serves HTTP and
splits the rows of each dispatch over both ranks, rank 1 follows.

The ranks are `python -m gsoc_wav2vec2_tpu_torch.cli.serve --sharded` started
by `tests/torch_parallel_ranks.py::launch` (torchrun's environment, gloo on
the loopback device, one thread a rank), each with a deadline.  A server of
`max_batch` 3 pads every transcribe batch (3 rows) and every single-row
dispatch (long-form, alignment, stream windows) with filler rows to a
multiple of the two ranks; a robust model's sample mask goes with them.  Its replies are held against a one-process port
server (in this process, the same weights, the same buckets and batch) and,
for transcripts, against the JAX package's sharded server on the virtual
8-device CPU mesh (its evaluator at f32, with the weights carried over by the
weight bridge).  Transcripts, word texts, frames and times must be equal;
word confidences (the mean probability of each word's frames, computed from
logits whose batch differs: 2 rows a rank against 3 in one process) within
1e-5.  SIGTERM to rank 0 stops both ranks with exit code 0; a follower that
is killed makes rank 0 exit non-zero within the group timeout; a leader that
cannot bind its port still stops the follower.  `--sharded` in one process
(no group, or torchrun with one process) serves as without it: no
heartbeat, no collective, and SIGTERM ends it with exit code 0.
"""

import dataclasses
import json
import os
import signal
import subprocess
import socket
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R
from tests.test_torch_serve import _get, _post, _wav_bytes

from gsoc_wav2vec2_tpu import Wav2Vec2Config
from gsoc_wav2vec2_tpu.cli import serve as jax_serve
from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu.models.modeling import init_wav2vec2_for_ctc_params
from gsoc_wav2vec2_tpu.parallel import make_mesh as jax_make_mesh
from gsoc_wav2vec2_tpu_torch.cli import serve
from gsoc_wav2vec2_tpu_torch.convert.jax_bridge import params_from_jax
from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor
from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC

torch.set_num_threads(2)
TINY = dict(hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32, 32], kernal_sizes=[10, 3], strides=[5, 2])
BUCKETS = (4000, 8000)
MAX_BATCH = 3
WINDOW_MS = 300.0
GROUP_TIMEOUT_S = 20.0
RANK_DEADLINE_S = 120.0
PROCESSOR = Wav2Vec2Processor(is_tokenizer=False)
# a body for each bucket, one past both (the long-form path), one of 3 bodies
LENGTHS = (3000, 6500, 2500, 11000)
CONFIDENCE_TOL = 1e-5


def _bodies():
    rng = np.random.default_rng(5)
    return [_wav_bytes((np.sin(np.arange(n) / (2.0 + i)) + 0.05 * rng.standard_normal(n))
                       .astype(np.float32) * 0.5) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def weights():
    config = Wav2Vec2Config(**TINY, dropout=0.0, apply_spec_augment=False, survival_prob=1.0)
    params = init_wav2vec2_for_ctc_params(jax.random.PRNGKey(0), config)
    model = Wav2Vec2ForCTC(port_config.Wav2Vec2Config(**dataclasses.asdict(config)), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return config, params, model


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, weights):
    d = str(tmp_path_factory.mktemp("serve_sharded") / "model")
    weights[2].save_pretrained(d)
    return d


# a rank of `cli.serve`: it joins the group first with the timeout of its
# first argument (as chip_smoke.py's rank processes do), which the server's
# `multihost.initialize` then keeps, and serves with the rest
RANK_MAIN = ("import sys\n"
             "from gsoc_wav2vec2_tpu_torch.parallel import multihost\n"
             "multihost.initialize('cpu', timeout_s=float(sys.argv[1]))\n"
             "from gsoc_wav2vec2_tpu_torch.cli import serve\n"
             "serve.main(sys.argv[2:])\n")


def _serve_argv(model_dir: str, *extra: str, port: int = 0):
    return ["--model_dir", model_dir, "--port", str(port), "--buckets", ",".join(map(str, BUCKETS)),
            "--max_batch", str(MAX_BATCH), "--batch_window_ms", str(WINDOW_MS), "--sharded",
            "--device", "cpu", *extra]


def _argv(model_dir: str, *extra: str, port: int = 0):
    return [sys.executable, "-c", RANK_MAIN, str(GROUP_TIMEOUT_S),
            *_serve_argv(model_dir, *extra, port=port)]


class _Ranks:
    """Two ranks of `cli.serve --sharded`: their output read by threads, rank
    0's address from its "serving on" line; every process killed at the
    deadline or on `kill()`."""

    def __init__(self, model_dir: str, *extra: str):
        argv = _argv(model_dir, *extra)
        self.deadline = time.monotonic() + RANK_DEADLINE_S
        self.procs = R.launch(lambda rank: argv, 2, RANK_DEADLINE_S)
        self.lines = [[], []]
        self.readers = [threading.Thread(target=self._read, args=(r,), daemon=True) for r in (0, 1)]
        for t in self.readers:
            t.start()
        self.base = None
        while self.base is None and time.monotonic() < self.deadline:
            served = [l for l in self.lines[0] if l.startswith("serving on ")]
            if served:
                self.base = served[0].split("serving on ", 1)[1].strip()
            elif any(p.poll() is not None for p in self.procs):
                break
            time.sleep(0.05)
        if self.base is None:
            self.kill()
            raise AssertionError(f"the sharded server did not start:\n{self.output()}")

    def _read(self, rank: int) -> None:
        for line in self.procs[rank].stdout:
            self.lines[rank].append(line)

    def output(self) -> str:
        return "\n---\n".join("".join(lines)[-3000:] for lines in self.lines)

    def wait(self, rank: int, timeout: float):
        try:
            return self.procs[rank].wait(timeout=max(min(timeout, self.deadline - time.monotonic()), 1.0))
        except Exception:
            self.kill()
            raise AssertionError(f"rank {rank} still running:\n{self.output()}")

    def stop(self):
        """SIGTERM to rank 0; both exit codes."""
        self.procs[0].send_signal(signal.SIGTERM)
        rcs = [self.wait(0, 60.0), self.wait(1, 60.0)]
        for t in self.readers:
            t.join(timeout=10)
        return rcs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


class _OneProcess:
    """The one-process port server (`cli.serve`'s parts, as its `main` wires
    them) at the same buckets, batch and window, in a thread."""

    def __init__(self, model, beam_width: int = 0):
        ev = GreedyCTCEvaluator(model, beam_width=beam_width)
        self.batcher = serve.DynamicBatcher(ev, buckets=BUCKETS, max_batch=MAX_BATCH,
                                            window_ms=WINDOW_MS)
        self.batcher.start()
        stats = {"model": "tiny", "buckets": list(BUCKETS), "max_batch": MAX_BATCH,
                 "beam_width": beam_width, "requests": 0, "streams": 0, "aligns": 0}
        streams = serve.StreamSessions(ev, device_lock=self.batcher.device_lock)
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(
            self.batcher, PROCESSOR, stats, streams=streams))
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.batcher.stop()


@pytest.fixture(scope="module")
def pair(model_dir, weights):
    """The sharded server and the one-process one, on the same weights."""
    ranks = _Ranks(model_dir)
    one = _OneProcess(weights[2])
    yield ranks, one
    one.close()
    ranks.kill()


def _transcribe(base, body, timestamps=False):
    status, out = _post(base + "/v1/transcribe" + ("?timestamps=1" if timestamps else ""),
                        body, "audio/wav")
    assert status == 200, out
    return out


def _same_words(got, want):
    assert [{k: v for k, v in w.items() if k != "confidence"} for w in got] == \
        [{k: v for k, v in w.items() if k != "confidence"} for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got], [w["confidence"] for w in want],
                               rtol=0, atol=CONFIDENCE_TOL)


def _stream(base, audio, **options):
    status, opened = _post(base + "/v1/stream", json.dumps(options).encode(), "application/json")
    assert status == 200, opened
    sid, feeds = opened["session"], []
    for lo in range(0, len(audio), 1300):
        status, out = _post(base + f"/v1/stream/{sid}",
                            json.dumps({"audio": audio[lo : lo + 1300].tolist()}).encode(),
                            "application/json")
        assert status == 200, out
        feeds.append(out)
    status, fin = _post(base + f"/v1/stream/{sid}/finish", b"", "application/json")
    assert status == 200, fin
    return feeds, fin


def test_sharded_replies_equal_one_process(pair):
    """Each body alone (both buckets and the long-form path), with word
    timestamps, an alignment and a stream session with timestamps: the
    sharded server's replies are the one-process server's."""
    ranks, one = pair
    assert any("sharded serving over 2 processes" in l for l in ranks.lines[0])
    assert all(any("backend gloo" in l for l in lines) for lines in ranks.lines)
    for body in _bodies():
        for ts in (False, True):
            got, want = _transcribe(ranks.base, body, ts), _transcribe(one.base, body, ts)
            assert got["transcription"] == want["transcription"] and got["batched_with"] == 1
            if ts:
                assert got["words"] and [w["word"] for w in got["words"]] == \
                    got["transcription"].split()
                _same_words(got["words"], want["words"])
    align = json.dumps({"audio": (0.3 * np.sin(np.arange(6500) / 4.0)).tolist(),
                        "transcript": "THE QUICK BROWN FOX"}).encode()
    (s1, got), (s2, want) = (_post(b + "/v1/align", align, "application/json")
                             for b in (ranks.base, one.base))
    assert s1 == s2 == 200 and got["transcription"] == want["transcription"] == "THE QUICK BROWN FOX"
    _same_words(got["words"], want["words"])
    audio = np.random.default_rng(7).standard_normal(9500).astype(np.float32)
    opts = dict(chunk_samples=3000, context_samples=500, normalize="none", timestamps=True)
    (feeds, fin), (feeds1, fin1) = _stream(ranks.base, audio, **opts), _stream(one.base, audio, **opts)
    assert [f["partial"] for f in feeds] == [f["partial"] for f in feeds1]
    assert fin["transcription"] == fin1["transcription"] and fin["transcription"]
    _same_words(fin["words"], fin1["words"])
    health = _get(ranks.base + "/healthz")
    assert health["status"] == "ok" and health["aligns"] == 1 and health["streams"] == 1


def test_three_concurrent_requests_ride_one_dispatch_with_a_filler_row(pair):
    """Three bodies of one bucket within the window: one (3, bucket) batch,
    padded to 4 rows for the two ranks; each reply is the one-process
    server's reply to the same three."""
    ranks, one = pair
    bodies = [_wav_bytes((0.4 * np.sin(np.arange(n) / (3.0 + k))).astype(np.float32))
              for k, n in enumerate((3500, 2000, 3900))]
    replies = {}
    for name, base in (("sharded", ranks.base), ("one", one.base)):
        out = [None] * len(bodies)

        def worker(i, base=base, out=out):
            out[i] = _transcribe(base, bodies[i], timestamps=True)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        replies[name] = out
    for got, want in zip(replies["sharded"], replies["one"]):
        assert got["transcription"] == want["transcription"]
        _same_words(got["words"], want["words"])
    assert max(r["batched_with"] for r in replies["sharded"]) == 3


def test_sharded_transcripts_equal_the_jax_sharded_server(pair, weights):
    """The JAX package's sharded server (its batcher and handler over an
    evaluator on the 8-device virtual CPU mesh, f32) and the port's two
    ranks give the same transcripts for the same bodies."""
    ranks, _ = pair
    config, params, _ = weights
    mesh = jax_make_mesh(model=1)
    assert mesh.devices.size == 8
    ev = JaxEvaluator(config, params, compute_dtype=jnp.float32, mesh=mesh)
    batcher = jax_serve.DynamicBatcher(ev, buckets=BUCKETS, max_batch=MAX_BATCH, window_ms=WINDOW_MS)
    batcher.start()
    stats = {"model": "tiny", "buckets": list(BUCKETS), "max_batch": MAX_BATCH, "beam_width": 0,
             "requests": 0, "streams": 0, "aligns": 0}
    server = ThreadingHTTPServer(("127.0.0.1", 0), jax_serve.make_handler(
        batcher, jax_serve.Wav2Vec2Processor(is_tokenizer=False), stats))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        for body in _bodies()[:3]:
            assert _transcribe(ranks.base, body)["transcription"] == \
                _transcribe(base, body)["transcription"]
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


def test_robust_family_sends_its_sample_mask(tmp_path):
    """A robust model takes a sample mask on every call: the leader
    broadcasts it with the rows (filler rows full length) and the replies,
    with timestamps, are the one-process server's."""
    model = Wav2Vec2ForCTC(port_config.RobustWav2Vec2Config(**TINY, dropout=0.0,
                                                             apply_spec_augment=False),
                           device="cpu", generator=torch.Generator().manual_seed(3))
    robust_dir = str(tmp_path / "robust")
    model.save_pretrained(robust_dir)
    ranks = _Ranks(robust_dir, "--no_warmup")
    one = _OneProcess(model)
    try:
        for body in _bodies():
            got, want = _transcribe(ranks.base, body, True), _transcribe(one.base, body, True)
            assert got["transcription"] == want["transcription"]
            _same_words(got["words"], want["words"])
    finally:
        one.close()
        ranks.kill()


def test_beam_server_decodes_as_one_process(model_dir, weights):
    """`--beam_width 3`: the device step sends each rank's log-probs back to
    the leader, whose beam search gives the one-process beams."""
    ranks = _Ranks(model_dir, "--beam_width", "3", "--no_warmup")
    one = _OneProcess(weights[2], beam_width=3)
    try:
        for body in _bodies():
            assert _transcribe(ranks.base, body)["transcription"] == \
                _transcribe(one.base, body)["transcription"]
        status, out = _post(ranks.base + "/v1/stream", b"", "application/json")
        assert status == 400 and "greedy" in out["error"]
    finally:
        one.close()
        ranks.kill()


def test_sigterm_to_the_leader_stops_both_ranks(model_dir):
    """The leader broadcasts stop on SIGTERM: both ranks exit with code 0."""
    ranks = _Ranks(model_dir, "--no_warmup")
    try:
        _transcribe(ranks.base, _bodies()[0])
        assert ranks.stop() == [0, 0], ranks.output()
        out = "".join(ranks.lines[1])
        assert "rank 1 follows rank 0" in out and "rank 1 stopped" in out
    finally:
        ranks.kill()


def test_a_killed_follower_stops_the_leader(model_dir):
    """Rank 1 killed: the leader's next collective fails (at the latest at
    the group timeout), it answers the request with an error and exits with
    a non-zero code instead of serving alone."""
    ranks = _Ranks(model_dir, "--no_warmup")
    try:
        ranks.procs[1].kill()
        ranks.procs[1].wait()
        t = time.monotonic()
        try:
            status, _ = _post(ranks.base + "/v1/transcribe", _bodies()[0], "audio/wav",
                              timeout=GROUP_TIMEOUT_S + 30)
            assert status == 500
        except OSError:
            pass  # the server closed the connection on its way out
        rc = ranks.wait(0, GROUP_TIMEOUT_S + 30)
        assert rc != 0 and time.monotonic() - t < GROUP_TIMEOUT_S + 30
        assert "a rank of the sharded server failed" in "".join(ranks.lines[0])
    finally:
        ranks.kill()


def test_a_leader_that_cannot_bind_its_port_stops_the_follower(model_dir):
    """The port is taken: the leader fails, and its stop still reaches the
    follower, which exits with code 0 instead of waiting for the group
    timeout."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        procs = R.launch(lambda rank: _argv(model_dir, "--no_warmup",
                                            port=taken.getsockname()[1]), 2, RANK_DEADLINE_S)
        (rc0, out0), (rc1, out1) = R.wait_all(procs, GROUP_TIMEOUT_S + 30)
    assert rc0 != 0 and "Address already in use" in out0, out0[-2000:]
    assert rc1 == 0 and "rank 1 stopped" in out1, out1[-2000:]



# `cli.serve --sharded` in one process, its heartbeat period cut to 0.2 s:
# were the heartbeat on, its first broadcast (no group) would stop the server
ONE_PROCESS_MAIN = ("import sys\n"
                    "from gsoc_wav2vec2_tpu_torch.parallel import multihost\n"
                    "multihost.group_timeout_s = lambda: 0.8\n"
                    "from gsoc_wav2vec2_tpu_torch.cli import serve\n"
                    "serve.main(sys.argv[1:])\n")


@pytest.mark.parametrize("world", [None, "1"], ids=["no_torchrun", "torchrun_one_process"])
def test_sharded_in_one_process_serves_and_stops_cleanly(model_dir, weights, world):
    """No group to join (no torchrun's environment, or a world of one):
    the server answers as the one-process one after many heartbeat
    periods, and SIGTERM ends it with exit code 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    if world is not None:
        env.update(WORLD_SIZE=world, RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE=world,
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(R.free_port()))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(R.ROOT), env.get("PYTHONPATH")]))
    proc = subprocess.Popen([sys.executable, "-c", ONE_PROCESS_MAIN,
                             *_serve_argv(model_dir, "--no_warmup")], cwd=str(R.ROOT), env=env,
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    one = _OneProcess(weights[2])
    try:
        deadline = time.monotonic() + RANK_DEADLINE_S
        while not any(l.startswith("serving on ") for l in lines) and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        served = [l for l in lines if l.startswith("serving on ")]
        assert served, "".join(lines)[-3000:]
        base = served[0].split("serving on ", 1)[1].strip()
        time.sleep(2.0)  # ten heartbeat periods
        body = _bodies()[0]
        assert _transcribe(base, body)["transcription"] == _transcribe(one.base, body)["transcription"]
        time.sleep(1.0)
        assert proc.poll() is None, "".join(lines)[-3000:]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        reader.join(timeout=10)
        out = "".join(lines)
        assert rc == 0, out[-3000:]
        assert "server stopped" in out and "sharded serving over" not in out, out[-3000:]
    finally:
        one.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()

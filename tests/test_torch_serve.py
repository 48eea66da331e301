"""The port's HTTP server (`cli/serve.py`), in process on the CPU on an
ephemeral port: ports of the cases of `tests/test_serve.py` (dynamic
batching, bucketed shapes, WAV/JSON payloads, the long-form fallback,
timestamps, alignment, stream sessions, error paths), with every served
transcript also held against the JAX evaluator's decode of the same padded
`(max_batch, bucket)` batch on the same weights.  The JAX file's sharded
case is `tests/test_torch_serve_sharded.py`'s.  One stress test holds the
server's device lock: no two evaluator calls overlap."""

import dataclasses
import io
import json
import sys
import threading
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsoc_wav2vec2_tpu import Wav2Vec2Config
from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu.models.modeling import init_wav2vec2_for_ctc_params
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
MAX_BATCH = 4
PROCESSOR = Wav2Vec2Processor(is_tokenizer=False)


def _wav_bytes(audio_f32: np.ndarray, rate: int = 16000) -> bytes:
    pcm = np.clip(audio_f32 * 32767.0, -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _quantised(audio: np.ndarray) -> np.ndarray:
    """What the WAV leg decodes: int16, then x / 32768."""
    return (np.clip(audio * 32767.0, -32768, 32767).astype(np.int16) / 32768.0).astype(np.float32)


def _post(url, body, content_type, timeout=120):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


class _Served:
    """`cli.serve`'s parts wired as its `main` wires them, serving from a
    thread of this process."""

    def __init__(self, evaluator, warmup=True, window_ms=300.0):
        self.evaluator = evaluator
        self.batcher = serve.DynamicBatcher(evaluator, buckets=BUCKETS, max_batch=MAX_BATCH,
                                            window_ms=window_ms)
        if warmup:
            self.batcher.warmup()
        self.batcher.start()
        self.stats = {"model": "tiny", "buckets": list(BUCKETS), "max_batch": MAX_BATCH,
                      "beam_width": evaluator.beam_width, "requests": 0, "streams": 0, "aligns": 0}
        self.streams = serve.StreamSessions(evaluator, device_lock=self.batcher.device_lock)
        self.server = ThreadingHTTPServer(
            ("127.0.0.1", 0),
            serve.make_handler(self.batcher, PROCESSOR, self.stats, streams=self.streams))
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.stop()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def weights():
    """The JAX package's tiny model and the port's, the weights carried across
    by `convert/jax_bridge.py`."""
    config = Wav2Vec2Config(**TINY, dropout=0.0, apply_spec_augment=False, survival_prob=1.0)
    params = init_wav2vec2_for_ctc_params(jax.random.PRNGKey(0), config)
    model = Wav2Vec2ForCTC(port_config.Wav2Vec2Config(**dataclasses.asdict(config)), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return config, params, model


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, weights):
    d = str(tmp_path_factory.mktemp("serve") / "model")
    weights[2].save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def jax_ev(weights):
    return JaxEvaluator(weights[0], weights[1], compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def server(weights):
    served = _Served(GreedyCTCEvaluator(weights[2]))
    health = _get(served.base + "/healthz")
    assert health["status"] == "ok" and health["buckets"] == [4000, 8000]
    yield served
    served.close()


def _jax_served(jax_ev, audio: np.ndarray):
    """The JAX evaluator's (text, words) for `audio` (raw, before the
    processor) as the server decodes it: alone in a (MAX_BATCH, bucket)
    batch, or long-form past the largest bucket."""
    speech = np.asarray(PROCESSOR(audio), np.float32)
    bucket = next((b for b in BUCKETS if len(speech) <= b), None)
    if bucket is None:
        return jax_ev.transcribe_long_segments(speech)
    batch = np.zeros((MAX_BATCH, bucket), np.float32)
    lengths = np.zeros((MAX_BATCH,), np.int64)
    batch[0, : len(speech)], lengths[0] = speech, len(speech)
    return jax_ev.predict_segments(batch, lengths)[0]


def _transcribe_json(base, audio, **extra):
    body = json.dumps({"audio": np.asarray(audio, np.float32).tolist(), **extra}).encode()
    return _post(base + "/v1/transcribe", body, "application/json")


def _words_close(got, want):
    assert [w["word"] for w in got] == [w["word"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["start_frame"] - w["start_frame"]) <= 1 and abs(g["end_frame"] - w["end_frame"]) <= 1


def test_json_transcribe_deterministic_and_matches_jax(server, jax_ev):
    rng = np.random.default_rng(0)
    audio = (np.sin(np.arange(3000) / 4.0) + 0.01 * rng.standard_normal(3000)).astype(np.float32)
    status, out = _transcribe_json(server.base, audio)
    assert status == 200, out
    assert out["audio_seconds"] == pytest.approx(3000 / 16000, abs=1e-3)
    assert out["latency_ms"] > 0 and out["batched_with"] >= 1 and "words" not in out
    status2, out2 = _transcribe_json(server.base, audio)
    assert status2 == 200 and out2["transcription"] == out["transcription"]
    assert out["transcription"] == _jax_served(jax_ev, audio)[0]


def test_wav_payload_matches_quantised_json(server, jax_ev):
    audio = np.sin(np.arange(5000) / 9.0).astype(np.float32) * 0.5
    status, out = _post(server.base + "/v1/transcribe", _wav_bytes(audio), "audio/wav")
    assert status == 200, out
    status2, out2 = _transcribe_json(server.base, _quantised(audio))
    assert status2 == 200 and out["transcription"] == out2["transcription"]
    assert out["transcription"] == _jax_served(jax_ev, _quantised(audio))[0]


def test_concurrent_requests_share_a_batch(server, jax_ev):
    rng = np.random.default_rng(1)
    audios = [(np.sin(np.arange(3500) / (3.0 + i)) + 0.02 * rng.standard_normal(3500)).astype(np.float32)
              for i in range(MAX_BATCH)]
    solo = []
    for audio in audios:
        status, out = _transcribe_json(server.base, audio)
        assert status == 200, out
        solo.append(out["transcription"])
    results = [None] * MAX_BATCH

    def worker(i):
        results[i] = _transcribe_json(server.base, audios[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(MAX_BATCH)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i, (status, out) in enumerate(results):
        assert status == 200, out
        # batching is a scheduling decision, never a semantic one
        assert out["transcription"] == solo[i] == _jax_served(jax_ev, audios[i])[0]
    assert max(out["batched_with"] for _, out in results) >= 2


def test_long_audio_uses_longform_path(server, jax_ev):
    audio = (np.sin(np.arange(20000) / 5.0) * 0.3).astype(np.float32)
    status, out = _transcribe_json(server.base, audio)
    assert status == 200, out
    assert out["batched_with"] == 1  # served alone
    assert out["transcription"] == _jax_served(jax_ev, audio)[0]


def test_error_paths(server):
    base = server.base
    status, out = _post(base + "/v1/transcribe", b"\x00garbage\x01", "")
    assert status == 400 and "unrecognised" in out["error"]
    status, out = _transcribe_json(base, [0.0], sample_rate=8000)
    assert status == 400 and "sample_rate" in out["error"]
    status, out = _post(base + "/v1/transcribe", json.dumps({"nope": 1}).encode(), "application/json")
    assert status == 400
    status, out = _transcribe_json(base, [])
    assert status == 400 and "non-empty" in out["error"]
    status, out = _post(base + "/v1/other", b"{}", "application/json")
    assert status == 404
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/nothing")
    before = _get(base + "/healthz")["requests"]
    status, _ = _transcribe_json(base, [0.1] * 600)
    assert status == 200
    assert _get(base + "/healthz")["requests"] >= before + 1


def test_timestamps_word_level(server, jax_ev):
    base = server.base
    rng = np.random.default_rng(7)
    audio = (np.sin(np.arange(3600) / 3.5) + 0.02 * rng.standard_normal(3600)).astype(np.float32)
    status, plain = _transcribe_json(base, audio)
    assert status == 200 and "words" not in plain
    status, out = _transcribe_json(base, audio, timestamps=True)
    assert status == 200, out
    assert out["transcription"] == plain["transcription"]
    words = out["words"]
    assert " ".join(w["word"] for w in words).split() == out["transcription"].split()
    prev_end = 0.0
    for w in words:
        assert 0.0 <= w["start"] < w["end"] <= out["audio_seconds"] + 0.1
        assert w["start"] >= prev_end
        prev_end = w["end"]
        assert 0.0 < w["confidence"] <= 1.0
    want_text, want_words = _jax_served(jax_ev, audio)
    assert out["transcription"] == want_text
    _words_close(words, want_words)
    status, out2 = _post(base + "/v1/transcribe?timestamps=1", _wav_bytes(audio), "audio/wav")
    assert status == 200 and isinstance(out2["words"], list)


def test_align_endpoint(server, jax_ev):
    audio = (np.sin(np.arange(5000) / 7.0) * 0.4).astype(np.float32)
    quantised = _quantised(audio)
    body = json.dumps({"audio": quantised.tolist(), "transcript": "hello,  world!"}).encode()
    status, out = _post(server.base + "/v1/align", body, "application/json")
    assert status == 200, out
    assert out["transcription"] == "HELLO WORLD" and out["batched_with"] == 1
    words = out["words"]
    assert [w["word"] for w in words] == ["HELLO", "WORLD"]
    prev_end = 0
    for w in words:
        assert prev_end <= w["start_frame"] < w["end_frame"]
        prev_end = w["end_frame"]
        assert 0.0 < w["confidence"] <= 1.0
    # the JAX evaluator's alignment at the bucket shape the server pads to
    want = jax_ev.align_segments(np.asarray(PROCESSOR(quantised), np.float32), "hello,  world!",
                                 chunk_samples=BUCKETS[-1], pad_to=8000)
    assert want[0] == out["transcription"]
    _words_close(words, want[1])
    status2, out2 = _post(server.base + "/v1/align?transcript=hello%20world", _wav_bytes(audio),
                          "audio/wav")
    assert status2 == 200, out2
    assert out2["transcription"] == out["transcription"] and out2["words"] == words
    status3, out3 = _post(server.base + "/v1/align", json.dumps({"audio": quantised.tolist()}).encode(),
                          "application/json")
    assert status3 == 400 and "transcript" in out3["error"]
    status4, out4 = _post(server.base + "/v1/align",
                          json.dumps({"audio": quantised[:300].tolist(),
                                      "transcript": "THE QUICK BROWN FOX " * 40}).encode(),
                          "application/json")
    assert status4 == 400 and "frames" in out4["error"]
    assert _get(server.base + "/healthz")["aligns"] >= 2


def test_beam_server_rejects_timestamps_and_streams(weights, jax_ev):
    """A beam-search server keeps no frame alignment: timestamp requests and
    stream opens answer 400; plain requests decode by beam as the JAX beam
    evaluator decodes the padded batch."""
    served = _Served(GreedyCTCEvaluator(weights[2], beam_width=3), warmup=False, window_ms=1.0)
    try:
        status, out = _transcribe_json(served.base, [0.1] * 600, timestamps=True)
        assert status == 400 and "greedy" in out["error"]
        status, out = _post(served.base + "/v1/stream", b"", "application/json")
        assert status == 400 and "greedy" in out["error"]
        audio = np.sin(np.arange(3000) / 3.0).astype(np.float32)
        status, out = _transcribe_json(served.base, audio)
        assert status == 200 and "words" not in out
        beam = JaxEvaluator(jax_ev.config, jax_ev.params, compute_dtype=jnp.float32, beam_width=3)
        batch = np.zeros((MAX_BATCH, 4000), np.float32)
        batch[0, :3000] = PROCESSOR(audio)
        assert out["transcription"] == beam.predict_batch(batch, np.array([3000, 0, 0, 0]))[0]
    finally:
        served.close()


def test_sharded_and_lm_without_beam_are_refused(model_dir, tmp_path):
    """`--sharded` is ported (tests/test_torch_serve_sharded.py): in one
    process it no longer raises, and its evaluator is the one-process one
    (a 1 x 1 mesh, rows not split, no collective); an LM without beam
    search is refused."""
    args = serve.parse_args(["--model_dir", model_dir, "--sharded", "--device", "cpu"])
    assert args.sharded
    mesh = serve.make_mesh(model=1)
    ev = serve.load_evaluator(args, mesh)
    assert not ev.shard_rows and (mesh.data, mesh.model) == (1, 1) and not ev._multiprocess
    assert len(ev.predict_batch(np.zeros((2, 4000), np.float32))) == 2
    with pytest.raises(SystemExit):
        serve.main(["--model_dir", model_dir, "--lm_path", str(tmp_path / "lm.json"),
                    "--device", "cpu"])


# -- streaming sessions (/v1/stream) ----------------------------------------


def _open_stream(base, **options):
    return _post(base + "/v1/stream", json.dumps(options).encode() if options else b"",
                 "application/json")


def _feed_json(base, sid, samples):
    return _post(base + f"/v1/stream/{sid}",
                 json.dumps({"audio": np.asarray(samples, np.float32).tolist()}).encode(),
                 "application/json")


def _finish(base, sid):
    return _post(base + f"/v1/stream/{sid}/finish", b"", "application/json")


def test_stream_session_piecewise_equals_one_piece_and_offline(server, jax_ev):
    base = server.base
    audio = np.random.default_rng(7).standard_normal(9500).astype(np.float32)
    opts = dict(chunk_samples=3000, context_samples=500, normalize="none")
    code, opened = _open_stream(base, **opts)
    assert code == 200 and opened["chunk_samples"] == 3000 and opened["normalize"] == "none"
    sid = opened["session"]
    partials = []
    for lo in range(0, len(audio), 1300):
        code, out = _feed_json(base, sid, audio[lo : lo + 1300])
        assert code == 200, out
        partials.append(out["partial"])
    assert out["samples_fed"] == len(audio)
    code, fin = _finish(base, sid)
    assert code == 200 and fin["audio_seconds"] == round(9500 / 16000, 3)
    for a, b in zip(partials, partials[1:] + [fin["transcription"]]):
        assert b.startswith(a)
    code, opened2 = _open_stream(base, **opts)
    code, _ = _feed_json(base, opened2["session"], audio)
    code, fin2 = _finish(base, opened2["session"])
    assert fin2["transcription"] == fin["transcription"] and fin["transcription"]
    # normalize "none" gives the offline long-form transcript, the JAX one too
    assert fin["transcription"] == server.evaluator.transcribe_long(audio, 3000, 500) == \
        jax_ev.transcribe_long(audio, 3000, 500)


def test_stream_session_word_timestamps(server):
    base = server.base
    audio = np.random.default_rng(11).standard_normal(9500).astype(np.float32)
    code, opened = _open_stream(base, chunk_samples=3000, context_samples=500, normalize="none",
                                timestamps=True)
    assert code == 200, opened
    sid = opened["session"]
    saw_words = False
    for lo in range(0, len(audio), 1300):
        code, out = _feed_json(base, sid, audio[lo : lo + 1300])
        assert code == 200 and "words" in out, out
        saw_words = saw_words or bool(out["words"])
    code, fin = _finish(base, sid)
    assert code == 200, fin
    words = fin["words"]
    assert saw_words and words
    assert " ".join(w["word"] for w in words).split() == fin["transcription"].split()
    prev_end = 0
    for w in words:
        assert prev_end <= w["start_frame"] < w["end_frame"]
        prev_end = w["end_frame"]
        assert 0.0 < w["confidence"] <= 1.0
    code, opened2 = _open_stream(base, chunk_samples=3000, context_samples=500, normalize="none")
    code, out = _feed_json(base, opened2["session"], audio[:2000])
    assert code == 200 and "words" not in out
    _finish(base, opened2["session"])


def test_stream_octet_pieces_match_json_pieces(server):
    base = server.base
    audio = np.random.default_rng(9).standard_normal(7000).astype(np.float32)
    opts = dict(chunk_samples=3000, context_samples=500, normalize="none")
    finals = []
    for mode in ("json", "octet"):
        code, opened = _open_stream(base, **opts)
        sid = opened["session"]
        for lo in range(0, len(audio), 2000):
            piece = audio[lo : lo + 2000]
            if mode == "json":
                code, out = _feed_json(base, sid, piece)
            else:
                code, out = _post(base + f"/v1/stream/{sid}", piece.astype("<f4").tobytes(),
                                  "application/octet-stream")
            assert code == 200, out
        code, fin = _finish(base, sid)
        finals.append(fin["transcription"])
    assert finals[0] == finals[1]


def test_stream_window_normalization_default(server):
    base = server.base
    raw = 3000.0 * np.sin(np.arange(9500) / 5.0).astype(np.float32)
    code, opened = _open_stream(base, chunk_samples=3000, context_samples=500)
    assert code == 200 and opened["normalize"] == "window"
    sid = opened["session"]
    for lo in range(0, len(raw), 4000):
        code, out = _feed_json(base, sid, raw[lo : lo + 4000])
        assert code == 200, out
    code, fin = _finish(base, sid)
    assert code == 200 and isinstance(fin["transcription"], str)


def test_stream_error_paths(server):
    base = server.base
    code, out = _feed_json(base, "s999999-0", np.zeros(10))
    assert code == 404 and "unknown" in out["error"]
    code, out = _open_stream(base, normalize="global")
    assert code == 400
    code, opened = _open_stream(base)
    sid = opened["session"]
    code, out = _post(base + f"/v1/stream/{sid}", b"\x00\x01\x02", "application/octet-stream")
    assert code == 400 and "float32" in out["error"]
    code, out = _post(base + f"/v1/stream/{sid}/x/y", b"", "application/json")
    assert code == 404
    code, _ = _finish(base, sid)
    assert code == 200
    code, out = _finish(base, sid)
    assert code == 404
    assert _get(base + "/healthz")["streams"] >= 1


def test_stream_sessions_reject_beam_and_cap_sessions(server):
    model = server.evaluator.model
    with pytest.raises(ValueError, match="greedy"):
        serve.StreamSessions(GreedyCTCEvaluator(model, beam_width=4)).open({})
    greedy = serve.StreamSessions(GreedyCTCEvaluator(model), max_sessions=1)
    sid = greedy.open({})
    with pytest.raises(OverflowError, match="too many"):
        greedy.open({})
    greedy.idle_timeout_s = -1.0  # every session is now idle: purged on the next open
    assert greedy.open({}) != sid
    with pytest.raises(KeyError):
        greedy.feed(sid, np.zeros(10, np.float32))


def test_device_lock_serialises_every_evaluator_call(model_dir):
    """Concurrent transcriptions, alignments and stream feeds from more
    threads than cores, with a short switch interval: no two evaluator steps
    ever run at once, and every request is answered."""
    evaluator = GreedyCTCEvaluator(Wav2Vec2ForCTC.from_pretrained(model_dir, device="cpu"))
    inside, most, guard = [0], [0], threading.Lock()
    step = evaluator._step

    def counted(*a, **kw):
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            return step(*a, **kw)
        finally:
            with guard:
                inside[0] -= 1

    evaluator._step = counted
    served = _Served(evaluator, warmup=False, window_ms=2.0)
    rng = np.random.default_rng(3)
    audios = [rng.standard_normal(int(rng.integers(800, 9000))).astype(np.float32) for _ in range(6)]
    codes = []

    def client(i):
        audio = audios[i % len(audios)]
        if i % 3 == 0:
            code, opened = _open_stream(served.base, chunk_samples=3000, context_samples=500)
            sid = opened["session"]
            for lo in range(0, len(audio), 1500):
                codes.append(_feed_json(served.base, sid, audio[lo : lo + 1500])[0])
            codes.append(_finish(served.base, sid)[0])
        elif i % 3 == 1:
            body = json.dumps({"audio": audio.tolist(), "transcript": "A B"}).encode()
            codes.append(_post(served.base + "/v1/align", body, "application/json")[0])
        else:
            codes.append(_transcribe_json(served.base, audio)[0])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        served.close()
    assert codes and all(c == 200 for c in codes), codes
    assert most[0] == 1

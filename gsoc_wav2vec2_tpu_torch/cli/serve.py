"""CLI: HTTP transcription server with dynamic batching (a port of
`gsoc_wav2vec2_tpu/cli/serve.py`: the same protocol, field names and
status codes).

  * a handful of **bucketed batch shapes**: every dispatch runs at one
    `(max_batch, bucket)` shape per bucket, so the card sees few shapes and
    padding waste stays bounded;
  * **dynamic batching**: concurrent requests landing within
    `--batch_window_ms` of each other ride one forward;
  * audio longer than the largest bucket falls back to overlapping-window
    long-form transcription (`evaluation.transcribe_long`);
  * greedy or prefix-beam decoding with optional char n-gram LM fusion
    (`--beam_width` / `--lm_path`, as on `cli.transcribe`).

Protocol (JSON over HTTP, standard library only):

  POST /v1/transcribe[?timestamps=1]
      body audio/wav | audio/flac | application/octet-stream (sniffed) |
      application/json {"audio": [float...], "sample_rate": 16000,
                        "timestamps": bool}
      -> {"transcription": str, "audio_seconds": float, "latency_ms": float,
          "batched_with": int[, "words": [{"word", "start", "end",
          "start_frame", "end_frame", "confidence"}, ...]]}
      (word timestamps are greedy-decode only; a beam server answers 400)
  POST /v1/align[?transcript=...]
      body as /v1/transcribe; JSON bodies carry {"audio": [...],
      "transcript": "..."} (binary audio passes the text in the query)
      -> {"transcription": <normalised transcript>, "words": [...],
          "audio_seconds", "latency_ms", "batched_with"}
      forced alignment of a known transcript (400 if it cannot fit the audio)
  POST /v1/stream                      (greedy servers only)
      optional JSON {"chunk_samples": int, "context_samples": int,
                     "normalize": "window" | "none", "timestamps": bool}
      -> {"session": id, "chunk_samples": int, "normalize": str}
  POST /v1/stream/<id>
      JSON {"audio": [float...]} | application/octet-stream of raw
      little-endian float32 samples
      -> {"partial": str, "samples_fed": int[, "words": [...]]}
      (`normalize: "window"`, the default, zscores each model window over
      its real samples, for live sources; `"none"` expects normalised audio
      and then gives the offline `transcribe_long` transcript exactly)
  POST /v1/stream/<id>/finish
      -> {"transcription": str, "audio_seconds": float[, "words": [...]]}
      closes the session
  GET /healthz
      -> {"status": "ok", "model": ..., "requests": N, ...}

Threads: one worker thread runs the batches; stream feeds and finishes run
on the HTTP handler threads.  Every evaluator call takes the server's one
device lock (`DynamicBatcher.device_lock`), so one thread at a time
launches on the card.

`--sharded`: one server over several ranks, one process a device (the JAX
server is one process over every local device).  Under `torchrun` every
rank loads the model on its card (`multihost.initialize`, a model=1 mesh);
rank 0, the leader, alone binds the port and runs the batcher, the streams,
the handlers and the host decode; each of its device calls is one dispatch
whose rows are split over the ranks (`GreedyCTCEvaluator(shard_rows=True)`),
and ranks >= 1 run `serve_follower` until the leader says stop (they ignore
SIGTERM and SIGINT: their stop comes from the leader).  The leader sends a
heartbeat every quarter of the group's timeout (`multihost.initialize`'s)
while idle, so a follower's wait never times out; a failed collective (a
lost rank) stops the server with exit code 1 rather than serving on the
leader alone.  In one process `--sharded` serves as without it.  On one card the
ranks share it over gloo, which moves each batch through the host: that
costs latency and adds no throughput.

Deliberate differences from the JAX server: there is no persistent
compilation cache to enable (the JAX server's is XLA's); and `--device`
picks the card (the default) or the CPU, as on the port's other CLIs.
`warmup()` still runs one forward per bucket: on the card it builds the
kernel library and PyTorch's cuBLAS and cuDNN plans before the first
request.

Usage:
    python -m gsoc_wav2vec2_tpu_torch.cli.serve --model_dir <dir> --port 8057
    torchrun --nproc_per_node 8 -m gsoc_wav2vec2_tpu_torch.cli.serve --sharded \
        --model_dir <dir> --port 8057
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..data.native_io import decode_flac_bytes, decode_wav_bytes
from ..data.processor import Wav2Vec2Processor
from ..decoding import CharNGramLM
from ..evaluation import GreedyCTCEvaluator
from ..models.modeling import Wav2Vec2ForCTC
from ..parallel import make_mesh, multihost
from ..streaming import StreamingTranscriber
from ..utils.devices import rank_device

DEFAULT_BUCKETS = (32000, 64000, 123000, 246000)


class _Request:
    """One queued utterance: normalised audio plus a completion event."""

    __slots__ = (
        "audio", "done", "text", "words", "want_timestamps", "error",
        "error_code", "batched_with", "enqueued", "transcript",
    )

    def __init__(self, audio: np.ndarray, want_timestamps: bool = False,
                 transcript: str | None = None):
        self.audio = audio
        self.done = threading.Event()
        self.text: str | None = None
        self.words: list | None = None
        self.want_timestamps = want_timestamps
        # non-None: forced alignment of this transcript instead of decoding
        self.transcript = transcript
        self.error: str | None = None
        self.error_code = 500
        self.batched_with = 0
        self.enqueued = time.perf_counter()


class DynamicBatcher:
    """Groups concurrent requests into bucketed device batches.

    One worker thread runs the batches: it blocks for the first pending
    request, gathers everything else that arrives within `window_ms` (up to
    `max_batch`), pads each bucket-group to the bucket's `(max_batch,
    bucket)` shape, and runs each as one forward.  Requests longer than the
    largest bucket are served one at a time through the long-form path, and
    so are alignments.  Base-family models take no attention mask, so the
    padding enters attention: a served transcript is the evaluator's decode
    of the padded batch, not of the unpadded audio.
    """

    def __init__(self, evaluator: GreedyCTCEvaluator, buckets=DEFAULT_BUCKETS,
                 max_batch: int = 8, window_ms: float = 20.0):
        self.evaluator = evaluator
        self.buckets = sorted(buckets)
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        # greedy servers always run the scored (argmax + frame-confidence)
        # step so that any request may ask for word timestamps; beam servers
        # keep no frame alignment, so timestamps are refused at the HTTP layer
        self.timestamps_supported = evaluator.beam_width == 0
        # held around every evaluator call of the server, stream sessions
        # included: one thread at a time launches on the card
        self.device_lock = threading.Lock()
        self._pending: list[_Request] = []
        self._cv = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)

    # -- public -----------------------------------------------------------

    def start(self) -> None:
        self._worker.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker.ident is not None:  # started
            self._worker.join(timeout=30)

    def warmup(self) -> None:
        """One forward per bucket shape, so that the first requests find the
        kernels built and the library plans made."""
        for bucket in self.buckets:
            speech = np.zeros((self.max_batch, bucket), np.float32)
            lengths = np.full((self.max_batch,), bucket, np.int64)
            with self.device_lock:
                if self.timestamps_supported:
                    self.evaluator.predict_segments(speech, lengths)
                else:
                    self.evaluator.predict_batch(speech, lengths)

    def submit(self, audio: np.ndarray, want_timestamps: bool = False,
               transcript: str | None = None) -> _Request:
        req = _Request(audio, want_timestamps, transcript)
        with self._cv:
            self._pending.append(req)
            self._cv.notify()
        return req

    # -- worker -----------------------------------------------------------

    def _take_batch(self) -> list[_Request]:
        with self._cv:
            while not self._pending and not self._stop:
                self._cv.wait()
            if self._stop and not self._pending:
                return []
            deadline = time.perf_counter() + self.window_s
            while (
                len(self._pending) < self.max_batch
                and not self._stop
                and (remaining := deadline - time.perf_counter()) > 0
            ):
                self._cv.wait(timeout=remaining)
            taken = self._pending[: self.max_batch]
            del self._pending[: len(taken)]
            return taken

    def _bucket_for(self, n: int):
        return next((b for b in self.buckets if n <= b), None)

    def _pad(self, reqs: list[_Request], bucket: int):
        """The group's audio as one (max_batch, bucket) batch and its true
        lengths; unused rows are zeros of length 0."""
        speech = np.zeros((self.max_batch, bucket), np.float32)
        lengths = np.zeros((self.max_batch,), np.int64)
        for i, req in enumerate(reqs):
            speech[i, : len(req.audio)] = req.audio
            lengths[i] = len(req.audio)
        return speech, lengths

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            groups: dict[int, list[_Request]] = {}
            longform: list[_Request] = []
            aligns: list[_Request] = []
            for req in batch:
                if req.transcript is not None:
                    aligns.append(req)
                    continue
                bucket = self._bucket_for(len(req.audio))
                if bucket is None:
                    longform.append(req)
                else:
                    groups.setdefault(bucket, []).append(req)
            for bucket, reqs in groups.items():
                try:
                    speech, lengths = self._pad(reqs, bucket)
                    with self.device_lock:
                        if self.timestamps_supported:
                            results = self.evaluator.predict_segments(speech, lengths)
                        else:
                            results = [(text, None) for text in
                                       self.evaluator.predict_batch(speech, lengths)]
                    for req, (text, words) in zip(reqs, results):
                        req.text, req.words = text, words
                        req.batched_with = len(reqs)
                except Exception as e:  # noqa: BLE001 — surface to the client
                    for req in reqs:
                        req.error = f"{type(e).__name__}: {e}"
                finally:
                    for req in reqs:
                        req.done.set()
            for req in longform:
                try:
                    with self.device_lock:
                        if self.timestamps_supported:
                            req.text, req.words = self.evaluator.transcribe_long_segments(req.audio)
                        else:
                            req.text = self.evaluator.transcribe_long(req.audio)
                    req.batched_with = 1
                except Exception as e:  # noqa: BLE001
                    req.error = f"{type(e).__name__}: {e}"
                finally:
                    req.done.set()
            for req in aligns:
                # the single-window pass pads to the request's bucket, so
                # alignments run at the bucket shapes too
                try:
                    with self.device_lock:
                        req.text, req.words = self.evaluator.align_segments(
                            req.audio, req.transcript, chunk_samples=self.buckets[-1],
                            pad_to=self._bucket_for(len(req.audio)),
                        )
                    req.batched_with = 1
                except ValueError as e:
                    # an infeasible transcript and the like: the client's fault
                    req.error, req.error_code = str(e), 400
                except Exception as e:  # noqa: BLE001
                    req.error = f"{type(e).__name__}: {e}"
                finally:
                    req.done.set()


class StreamSessions:
    """Registry of live `StreamingTranscriber` sessions.

    Each session serialises its own feeds with a per-session lock (pieces
    must commit in arrival order); every feed and finish also takes the
    device lock, shared with the batcher when one is given.  Idle sessions
    expire lazily so that abandoned streams cannot pin memory."""

    def __init__(self, evaluator: GreedyCTCEvaluator, max_sessions: int = 64,
                 idle_timeout_s: float = 300.0, device_lock: threading.Lock | None = None):
        self.evaluator = evaluator
        self.max_sessions = max_sessions
        self.idle_timeout_s = idle_timeout_s
        self.supported = evaluator.beam_width == 0
        self.device_lock = device_lock if device_lock is not None else threading.Lock()
        self._lock = threading.Lock()
        self._sessions: dict[str, dict] = {}
        self._counter = 0

    def _purge_idle_locked(self) -> None:
        now = time.monotonic()
        for sid in [s for s, e in self._sessions.items() if now - e["last"] > self.idle_timeout_s]:
            del self._sessions[sid]

    def open(self, options: dict) -> str:
        if not self.supported:
            raise ValueError(
                "streaming requires greedy decoding; this server runs beam "
                "search (--beam_width > 0)"
            )
        normalize = options.get("normalize", "window")
        if normalize not in ("window", "none"):
            raise ValueError('normalize must be "window" or "none"')
        st = StreamingTranscriber(
            self.evaluator,
            chunk_samples=int(options.get("chunk_samples", 246000)),
            context_samples=int(options.get("context_samples", 16000)),
            normalize_window=(normalize == "window"),
            word_timestamps=bool(options.get("timestamps", False)),
        )
        with self._lock:
            self._purge_idle_locked()
            if len(self._sessions) >= self.max_sessions:
                raise OverflowError(f"too many live streams (max {self.max_sessions})")
            self._counter += 1
            sid = f"s{self._counter:06d}-{int(time.time())}"
            self._sessions[sid] = {"st": st, "lock": threading.Lock(), "last": time.monotonic()}
        return sid

    def _entry(self, sid: str) -> dict:
        with self._lock:
            self._purge_idle_locked()
            entry = self._sessions.get(sid)
        if entry is None:
            raise KeyError(f"unknown or expired stream session {sid!r}")
        return entry

    def feed(self, sid: str, samples: np.ndarray) -> dict:
        entry = self._entry(sid)
        with entry["lock"]:
            st = entry["st"]
            with self.device_lock:
                partial = st.feed(samples)
            entry["last"] = time.monotonic()
            reply = {"partial": partial, "samples_fed": st.samples_fed}
            if st.word_timestamps:
                reply["words"] = st.words  # committed words: live captions
            return reply

    def finish(self, sid: str) -> dict:
        entry = self._entry(sid)
        with entry["lock"]:
            st = entry["st"]
            with self.device_lock:
                text = st.finish()
            total = st.samples_fed
            words = st.words if st.word_timestamps else None
        with self._lock:
            self._sessions.pop(sid, None)
        reply = {"transcription": text, "audio_seconds": round(total / 16000.0, 3)}
        if words is not None:
            reply["words"] = words
        return reply


def _parse_stream_piece(body: bytes, content_type: str) -> np.ndarray:
    """A stream piece: JSON {"audio": [...]} or raw little-endian float32."""
    if content_type.startswith("application/json"):
        payload = json.loads(body)
        if "audio" not in payload:
            raise ValueError('JSON body needs an "audio" array')
        return np.asarray(payload["audio"], np.float32)
    if len(body) % 4:
        raise ValueError("octet-stream pieces must be raw little-endian float32 samples")
    return np.frombuffer(body, dtype="<f4").astype(np.float32)


def _parse_audio(body: bytes, content_type: str):
    """Raw request body -> (float32 waveform, want_timestamps).

    Sniffs WAV/FLAC magic; JSON bodies may also carry a boolean
    `"timestamps"` (binary payloads ask through `?timestamps=1`)."""
    if content_type.startswith("application/json"):
        payload = json.loads(body)
        if "audio" not in payload:
            raise ValueError('JSON body needs an "audio" array')
        rate = int(payload.get("sample_rate", 16000))
        if rate != 16000:
            raise ValueError(f"sample_rate {rate} != 16000")
        return np.asarray(payload["audio"], np.float32), bool(payload.get("timestamps", False))
    if body[:4] == b"RIFF":
        audio, rate = decode_wav_bytes(body, "<request>")
    elif body[:4] == b"fLaC":
        audio, rate = decode_flac_bytes(body, "<request>")
    else:
        raise ValueError("unrecognised audio payload (want WAV, FLAC, or JSON)")
    if rate != 16000:
        raise ValueError(f"sample rate {rate} != 16000")
    return np.asarray(audio, np.float32), False


def _parse_align(body: bytes, content_type: str, query: dict):
    """/v1/align body -> (float32 waveform, transcript string).

    JSON bodies carry {"audio": [...], "transcript": "..."}; binary WAV/FLAC
    bodies pass the text in the `?transcript=` query parameter."""
    if content_type.startswith("application/json"):
        payload = json.loads(body)
        if "audio" not in payload:
            raise ValueError('JSON body needs an "audio" array')
        rate = int(payload.get("sample_rate", 16000))
        if rate != 16000:
            raise ValueError(f"sample_rate {rate} != 16000")
        audio = np.asarray(payload["audio"], np.float32)
        transcript = payload.get("transcript")
    else:
        audio, _ = _parse_audio(body, content_type)
        qs = query.get("transcript", [])
        transcript = qs[-1] if qs else None
    if not transcript or not str(transcript).strip():
        raise ValueError(
            'alignment needs a non-empty "transcript" (JSON field or '
            "?transcript= query parameter)"
        )
    return audio, str(transcript)


def make_handler(batcher: DynamicBatcher, processor, stats: dict,
                 streams: StreamSessions | None = None):
    stats_lock = threading.Lock()  # the handler threads count into `stats`

    def count(key: str) -> None:
        with stats_lock:
            stats[key] += 1

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet access log
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — http.server contract
            if self.path not in ("/healthz", "/"):
                self._reply(404, {"error": "not found"})
                return
            with stats_lock:
                health = {"status": "ok", **stats}
            self._reply(200, health)

        def _do_stream(self, parsed) -> None:
            """/v1/stream routes: open / feed / finish."""
            parts = parsed.path.strip("/").split("/")  # ["v1", "stream", ...]
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                if len(parts) == 2:  # open
                    options = json.loads(body) if body else {}
                    sid = streams.open(options)
                    count("streams")
                    self._reply(200, {
                        "session": sid,
                        "chunk_samples": int(options.get("chunk_samples", 246000)),
                        "normalize": options.get("normalize", "window"),
                    })
                elif len(parts) == 3 and parts[2] != "finish":  # feed
                    samples = _parse_stream_piece(body, self.headers.get("Content-Type", ""))
                    self._reply(200, streams.feed(parts[2], samples))
                elif len(parts) == 4 and parts[3] == "finish":
                    self._reply(200, streams.finish(parts[2]))
                else:
                    self._reply(404, {"error": "not found"})
            except KeyError as e:
                self._reply(404, {"error": str(e).strip("'")})
            except OverflowError as e:
                self._reply(429, {"error": str(e)})
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})

        def do_POST(self) -> None:  # noqa: N802
            parsed = urlparse(self.path)
            if streams is not None and parsed.path.startswith("/v1/stream"):
                self._do_stream(parsed)
                return
            if parsed.path not in ("/v1/transcribe", "/v1/align"):
                self._reply(404, {"error": "not found"})
                return
            aligning = parsed.path == "/v1/align"
            start = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                transcript = None
                if aligning:
                    audio, transcript = _parse_align(
                        body, self.headers.get("Content-Type", ""), parse_qs(parsed.query))
                    want_ts = False
                else:
                    audio, want_ts = _parse_audio(body, self.headers.get("Content-Type", ""))
                    qs = parse_qs(parsed.query).get("timestamps", [])
                    want_ts = want_ts or bool(qs and qs[-1].lower() in ("1", "true", "yes"))
                    if want_ts and not batcher.timestamps_supported:
                        raise ValueError(
                            "timestamps require greedy decoding; this server "
                            "runs beam search (--beam_width > 0)"
                        )
                if audio.ndim != 1 or len(audio) == 0:
                    raise ValueError("audio must be a non-empty 1-D waveform")
                speech = np.asarray(processor(audio), np.float32)
            except (ValueError, OSError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            req = batcher.submit(speech, want_timestamps=want_ts, transcript=transcript)
            req.done.wait()
            if req.error is not None:
                self._reply(req.error_code, {"error": req.error})
                return
            count("aligns" if aligning else "requests")
            payload = {
                "transcription": req.text,
                "audio_seconds": round(len(audio) / 16000.0, 3),
                "latency_ms": round((time.perf_counter() - start) * 1000.0, 2),
                "batched_with": req.batched_with,
            }
            if req.want_timestamps or aligning:
                payload["words"] = req.words
            self._reply(200, payload)

    return Handler


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        "wav2vec2 transcription server (PyTorch port)",
        epilog="Requests run at bucketed batch shapes; for BASE-family "
        "models (GroupNorm conv stack, no attention mask) that padding can "
        "move near-tie decode/alignment boundaries by one frame against an "
        "unpadded offline decode; robust/XLSR models are padding-invariant.",
    )
    parser.add_argument("--model_dir", required=True, type=str)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8057)
    parser.add_argument(
        "--buckets", type=str, default=",".join(map(str, DEFAULT_BUCKETS)),
        help="comma-separated sample-length buckets (one batch shape each)",
    )
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument(
        "--batch_window_ms", type=float, default=20.0,
        help="how long the batcher waits to co-schedule concurrent requests",
    )
    parser.add_argument("--beam_width", type=int, default=0)
    parser.add_argument("--lm_path", type=str, default=None)
    parser.add_argument("--lm_weight", type=float, default=0.5)
    parser.add_argument("--token_bonus", type=float, default=0.0)
    parser.add_argument(
        "--no_warmup", action="store_true",
        help="skip the startup forward of each bucket shape",
    )
    parser.add_argument("--max_streams", type=int, default=64,
                        help="maximum concurrent /v1/stream sessions")
    parser.add_argument(
        "--stream_idle_timeout_s", type=float, default=300.0,
        help="idle seconds before an abandoned stream session expires",
    )
    parser.add_argument(
        "--sharded", action="store_true",
        help="one server over every rank of torchrun (one process a card): rank 0 serves "
             "HTTP and splits the rows of each batch over the ranks",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="cuda (bf16 kernels; the default) or cpu (f32 plain path)",
    )
    args = parser.parse_args(argv)
    if args.lm_path and args.beam_width <= 0:
        parser.error("--lm_path requires --beam_width > 0")
    return args


def load_evaluator(args: argparse.Namespace, mesh=None) -> GreedyCTCEvaluator:
    """The model of `--model_dir` on `--device` (with `--sharded`, this
    rank's card), and its evaluator with the decode flags; with `--sharded`
    under a `mesh` of several ranks each `_step` of rank 0 is split over
    them."""
    lm = CharNGramLM.load(args.lm_path) if args.lm_path else None
    device = rank_device(args.device) if args.sharded else args.device
    model = Wav2Vec2ForCTC.from_pretrained(args.model_dir, device=device)
    return GreedyCTCEvaluator(model, beam_width=args.beam_width, lm=lm,
                              lm_weight=args.lm_weight, token_bonus=args.token_bonus,
                              mesh=mesh, shard_rows=args.sharded)


def _follow(evaluator: GreedyCTCEvaluator) -> None:
    """A follower rank: run the leader's dispatches until it says stop."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    rank = multihost.rank()
    print(f"rank {rank} follows rank 0", file=sys.stderr, flush=True)
    evaluator.serve_follower()
    multihost.shutdown()
    print(f"rank {rank} stopped", file=sys.stderr)


def main(argv=None) -> None:
    args = parse_args(argv)
    mesh = None
    if args.sharded:
        multihost.initialize(rank_device(args.device))
        mesh = make_mesh(model=1)  # every rank on the data axis
    evaluator = load_evaluator(args, mesh)
    if mesh is not None and mesh.rank > 0:
        _follow(evaluator)
        return
    if evaluator.shard_rows:
        print(f"sharded serving over {mesh.size} processes", flush=True)
    buckets = [int(b) for b in args.buckets.split(",") if b]
    batcher = DynamicBatcher(evaluator, buckets=buckets, max_batch=args.max_batch,
                             window_ms=args.batch_window_ms)
    done = threading.Event()
    server = None
    # from here on the followers wait for this rank: whatever ends it, stop them
    try:
        if not args.no_warmup:
            print(f"warming up {len(buckets)} bucket shapes...", flush=True)
            batcher.warmup()
        batcher.start()

        stats = {
            "model": args.model_dir,
            "buckets": buckets,
            "max_batch": args.max_batch,
            "beam_width": args.beam_width,
            "requests": 0,
            "streams": 0,
            "aligns": 0,
        }
        streams = StreamSessions(evaluator, max_sessions=args.max_streams,
                                 idle_timeout_s=args.stream_idle_timeout_s,
                                 device_lock=batcher.device_lock)
        server = ThreadingHTTPServer(
            (args.host, args.port),
            make_handler(batcher, Wav2Vec2Processor(is_tokenizer=False), stats, streams=streams),
        )

        def shutdown(signum, frame):  # noqa: ARG001
            threading.Thread(target=server.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, shutdown)
        signal.signal(signal.SIGINT, shutdown)
        if evaluator.shard_rows:
            def peer_lost(exc):
                print(f"a rank of the sharded server failed ({type(exc).__name__}: {exc}); "
                      "stopping", file=sys.stderr, flush=True)
                shutdown(None, None)

            def keep_alive():
                while not done.wait(multihost.group_timeout_s() / 4):
                    try:
                        with batcher.device_lock:
                            evaluator.heartbeat()
                    except Exception:  # noqa: BLE001 — reported through on_peer_lost
                        return

            evaluator.on_peer_lost = peer_lost
            threading.Thread(target=keep_alive, daemon=True).start()
        print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
        server.serve_forever()
    finally:
        done.set()
        batcher.stop()
        if server is not None:
            server.server_close()
        if evaluator.shard_rows and evaluator.peer_lost is None:
            try:
                with batcher.device_lock:
                    evaluator.stop_followers()
            except Exception:  # noqa: BLE001 — recorded in peer_lost
                pass
    if evaluator.peer_lost is not None:
        print("server stopped: a rank was lost", file=sys.stderr)
        raise SystemExit(1)
    multihost.shutdown()
    print("server stopped", file=sys.stderr)


if __name__ == "__main__":
    main()

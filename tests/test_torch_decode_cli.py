"""The port's decoding CLIs against the JAX CLIs' JSON lines, both in process
on the CPU on one model directory (the JAX CLIs' evaluator held at f32, the
port's CPU dtype): `cli.transcribe` with `--timestamps`, `--stream`,
`--beam_width` and `--lm_path`, and its refusals of illegal combinations;
`cli.evaluate` with `--beam_width`, `--lm_path` and `--lm_fit_dir`
(hypotheses utterance by utterance); `cli.align` with `--transcript`, sibling
TIMIT-style transcripts and its per-file errors.  Equal transcripts and
words; word frames within one frame, confidences within 2e-3."""

import functools
import json
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flac_encoder import encode_flac

from gsoc_wav2vec2_tpu import Wav2Vec2Config
from gsoc_wav2vec2_tpu import Wav2Vec2ForCTC as JaxWav2Vec2ForCTC
from gsoc_wav2vec2_tpu.cli import align as jax_align
from gsoc_wav2vec2_tpu.cli import evaluate as jax_evaluate
from gsoc_wav2vec2_tpu.cli import transcribe as jax_transcribe
from gsoc_wav2vec2_tpu.decoding import CharNGramLM as JaxLM
from gsoc_wav2vec2_tpu.evaluation import GreedyCTCEvaluator as JaxEvaluator
from gsoc_wav2vec2_tpu_torch.cli import align, evaluate, transcribe
from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator

torch.set_num_threads(2)
TINY = dict(hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32, 32], kernal_sizes=[10, 3], strides=[5, 2],
            dropout=0.0, apply_spec_augment=False, survival_prob=1.0)
CHUNK = ["--chunk_samples", "3000", "--context_samples", "500"]


def _write_wav(path, n, rate=16000, scale=1800.0, period=6.0):
    pcm = np.clip(scale * np.sin(np.arange(n) / period)
                  + np.random.default_rng(n).integers(-300, 300, n), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode_cli")
    model_dir = str(tmp / "model")
    JaxWav2Vec2ForCTC(Wav2Vec2Config(**TINY), seed=0).save_pretrained(model_dir)
    rng = np.random.default_rng(0)
    seqs = [[int(s) for s in rng.integers(4, 32, size=int(rng.integers(3, 15)))] for _ in range(40)]
    lm_path = str(tmp / "lm.json")
    JaxLM(3, 32).fit(seqs).save(lm_path)
    return {"model": model_dir, "lm": lm_path,
            "clip": _write_wav(tmp / "clip.wav", 12000),
            "long": _write_wav(tmp / "long.wav", 9500, scale=3000.0, period=5.0)}


@pytest.fixture
def jax_f32(monkeypatch):
    """The JAX CLIs build their evaluator at bf16 by default; hold them at
    f32, the port's CPU dtype."""
    f32 = functools.partial(JaxEvaluator, compute_dtype=jnp.float32)
    for mod in (jax_transcribe, jax_evaluate, jax_align):
        monkeypatch.setattr(mod, "GreedyCTCEvaluator", f32)


def _json_lines(out):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def _run_both(main_port, main_jax, argv, capsys, monkeypatch, exit_code=None):
    """(port lines, JAX lines) of the two CLIs on the same arguments."""
    outs = []
    for main, extra in ((main_port, ["--device", "cpu"]), (main_jax, [])):
        monkeypatch.setattr(sys, "argv", ["cli", *argv, *extra])
        if exit_code is None:
            main(argv + extra) if main is not main_jax else main()
        else:
            with pytest.raises(SystemExit) as e:
                main(argv + extra) if main is not main_jax else main()
            assert e.value.code == exit_code
        outs.append(_json_lines(capsys.readouterr().out))
    return outs


def _assert_lines_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if key == "words":
                assert [x["word"] for x in g[key]] == [x["word"] for x in w[key]]
                for a, b in zip(g[key], w[key]):
                    assert set(a) == set(b)
                    assert abs(a["start_frame"] - b["start_frame"]) <= 1
                    assert abs(a["end_frame"] - b["end_frame"]) <= 1
                    assert a["confidence"] == pytest.approx(b["confidence"], abs=2e-3)
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize("flags", [
    [], ["--timestamps"], ["--stream", "--stream_chunk_s", "0.1"],
    ["--stream", "--stream_chunk_s", "0.1", "--timestamps"], ["--beam_width", "4"],
    ["--beam_width", "4", "--lm_path", "LM", "--lm_weight", "0.3", "--token_bonus", "0.5"],
], ids=["greedy", "timestamps", "stream", "stream_timestamps", "beam", "beam_lm"])
def test_transcribe_cli_matches_jax(files, jax_f32, capsys, monkeypatch, flags):
    flags = [files["lm"] if f == "LM" else f for f in flags]
    argv = ["--model_dir", files["model"], *CHUNK, *flags, files["long"], files["clip"]]
    got, want = _run_both(transcribe.main, jax_transcribe.main, argv, capsys, monkeypatch)
    _assert_lines_match(got, want)
    finals = [l for l in got if "transcription" in l]
    assert [l["file"] for l in finals] == [files["long"], files["clip"]]
    if "--stream" in flags:
        partials = [l["partial"] for l in got if l["file"] == files["long"] and "partial" in l]
        assert partials
        for a, b in zip(partials, partials[1:] + [finals[0]["transcription"]]):
            assert b.startswith(a)
        # the final line is the offline transcript of the same CLI
        argv = ["--model_dir", files["model"], *CHUNK, files["long"], "--device", "cpu"]
        transcribe.main(argv)
        assert _json_lines(capsys.readouterr().out)[0]["transcription"] == finals[0]["transcription"]


@pytest.mark.parametrize("flags,message", [
    (["--timestamps", "--beam_width", "4"], "greedy"),
    (["--stream", "--beam_width", "4"], "greedy"),
    (["--lm_path", "lm.json"], "requires --beam_width"),
    (["--beam_width", "4", "--token_bonus", "1.0"], "only act with --lm_path"),
])
def test_transcribe_cli_refuses_illegal_combinations(files, jax_f32, capsys, monkeypatch, flags,
                                                     message):
    argv = ["--model_dir", files["model"], *flags, "nofile.wav"]
    for main, extra in ((transcribe.main, ["--device", "cpu"]), (jax_transcribe.main, [])):
        monkeypatch.setattr(sys, "argv", ["cli", *argv, *extra])
        with pytest.raises(SystemExit) as e:
            main(argv + extra) if main is transcribe.main else main()
        assert e.value.code == 2 and message in capsys.readouterr().err


def _corpus(root, texts=("HELLO WORLD", "TINY MODEL", "SOME WORDS")):
    chap = root / "1" / "1"
    chap.mkdir(parents=True)
    lines = []
    for i, text in enumerate(texts):
        n = 2400 + 900 * i
        sig = np.clip(1500 * np.sin(np.arange(n) / (3.0 + i)), -32768, 32767).astype(np.int64)
        (chap / f"1-1-{i:04d}.flac").write_bytes(encode_flac(sig, subframe_kind="fixed", order=2,
                                                             rice_param=7))
        lines.append(f"1-1-{i:04d} {text}")
    (chap / "1-1.trans.txt").write_text("\n".join(lines))
    return str(root)


def _recording(monkeypatch, cls, calls):
    predict = cls.predict_batch

    def recorded(self, speech, sample_lengths=None):
        hyps = predict(self, speech, sample_lengths)
        calls.append((np.array(speech), list(hyps)))
        return hyps

    monkeypatch.setattr(cls, "predict_batch", recorded)


@pytest.mark.parametrize("mode,flags", [
    ("padded", ["--beam_width", "4", "--lm_path", "LM", "--lm_weight", "0.3", "--pad_to", "6000",
                "--batch_size", "2"]),
    ("bucketed", ["--beam_width", "4"]),
    ("single", ["--beam_width", "3", "--lm_fit_dir", "CORPUS", "--lm_path", "FIT",
                "--token_bonus", "0.5"]),
])
def test_evaluate_cli_beam_and_lm_match_jax(files, jax_f32, tmp_path, capsys, monkeypatch, mode,
                                            flags):
    corpus = _corpus(tmp_path / "corpus")
    subs = {"LM": files["lm"], "CORPUS": corpus, "FIT": str(tmp_path / "fit.json")}
    flags = [subs.get(f, f) for f in flags]
    calls = {"port": [], "jax": []}
    _recording(monkeypatch, GreedyCTCEvaluator, calls["port"])
    _recording(monkeypatch, JaxEvaluator, calls["jax"])
    argv = ["--model_dir", files["model"], "--data_dir", corpus, "--mode", mode, *flags]
    (got,), (want,) = _run_both(evaluate.main, jax_evaluate.main, argv, capsys, monkeypatch)
    assert len(calls["port"]) == len(calls["jax"]) > 0
    for (speech, hyps), (want_speech, want_hyps) in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(speech, want_speech)
        assert hyps == want_hyps
    assert sum(len(h) for _, h in calls["port"]) == 3
    got.pop("seconds"), want.pop("seconds")
    assert got == want and got["beam_width"] == int(flags[1])
    assert ("lm" in got) == ("--lm_path" in flags)
    if "--lm_fit_dir" in flags:  # the fitted LM was saved, as the JAX CLI saves it
        assert JaxLM.load(subs["FIT"]).counts and np.isfinite(JaxLM.load(subs["FIT"]).logp((11, 5), 15))


def test_evaluate_cli_refusals(files, tmp_path, capsys):
    corpus = _corpus(tmp_path / "corpus")
    base = ["--model_dir", files["model"], "--data_dir", corpus, "--device", "cpu"]
    for flags, message in ((["--sharded", "--mode", "single"], "padded or bucketed"),
                           (["--lm_path", files["lm"]], "require --beam_width"),
                           (["--beam_width", "2", "--lm_weight", "0.2"], "only act with")):
        with pytest.raises(SystemExit) as e:
            evaluate.main(base + flags)
        assert e.value.code == 2 and message in capsys.readouterr().err


def test_align_cli_matches_jax(files, jax_f32, tmp_path, capsys, monkeypatch):
    clip = _write_wav(tmp_path / "clip.wav", 12000)
    (tmp_path / "clip.TXT").write_text("0 12000 she had your dark suit\n")
    model = ["--model_dir", files["model"]]
    got, want = _run_both(align.main, jax_align.main, model + [clip, "--transcript", "HELLO WORLD"],
                          capsys, monkeypatch)
    _assert_lines_match(got, want)
    assert got[0]["transcription"] == "HELLO WORLD"
    assert [w["word"] for w in got[0]["words"]] == ["HELLO", "WORLD"]
    # a sibling .TXT with TIMIT's sample offsets stripped; long form in windows
    got, want = _run_both(align.main, jax_align.main, model + [clip, "--chunk_samples", "4000",
                                                               "--context_samples", "500"],
                          capsys, monkeypatch)
    _assert_lines_match(got, want)
    assert got[0]["transcription"] == "SHE HAD YOUR DARK SUIT"
    # an infeasible transcript: a JSON error line, exit code 1
    got, want = _run_both(align.main, jax_align.main,
                          model + [clip, "--transcript", "THE QUICK BROWN FOX " * 100],
                          capsys, monkeypatch, exit_code=1)
    assert got == want and "frames" in got[0]["error"]
    # per-file errors in one batch: a wrong rate and a missing transcript
    badrate = _write_wav(tmp_path / "badrate.wav", 4000, rate=8000)
    (tmp_path / "badrate.txt").write_text("HELLO\n")
    orphan = tmp_path / "orphan.wav"
    orphan.write_bytes(open(clip, "rb").read())
    got, want = _run_both(align.main, jax_align.main, model + [badrate, str(orphan), clip],
                          capsys, monkeypatch, exit_code=1)
    _assert_lines_match(got, want)
    assert "sample rate 8000" in got[0]["error"] and "no transcript" in got[1]["error"]
    assert got[2]["transcription"] == "SHE HAD YOUR DARK SUIT"
    # --transcript with two files is a usage error
    with pytest.raises(SystemExit) as e:
        align.main(model + [clip, clip, "--transcript", "HI", "--device", "cpu"])
    assert e.value.code == 2

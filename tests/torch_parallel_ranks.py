"""Rank programs for the port's parallel tests (`tests/test_torch_parallel*.py`).

`run_ranks(case, world, kwargs, tmp)` starts `world` processes of
`python tests/torch_parallel_ranks.py`, each one rank of a gloo process
group on the CPU at one thread (torchrun's environment: MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), runs `CASES[case](**kwargs)` and
returns every rank's result.  Each run has a deadline: a hang fails the test
instead of stalling the suite.  The same case functions run in the test's own
process as the one-process reference (no process group: a 1 x 1 mesh).

Imports the port only (no JAX), so that a rank starts in about two seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# tests/utils.py::tiny_config (which builds the JAX package's config)
TINY = dict(vocab_size=32, hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32] * 7, kernal_sizes=[10, 3, 3, 3, 3, 2, 2],
            strides=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=128,
            num_conv_pos_embedding_groups=16, dropout=0.0, apply_spec_augment=False)
TINY_PRETRAINING = dict(TINY, num_codevector_groups=2, num_codevectors_per_group=16,
                        codevector_dim=48, proj_codevector_dim=40, num_negatives=10)
SAMPLES = 8000


def port_config(robust: bool = False, **kw):
    from gsoc_wav2vec2_tpu_torch.models import config as c

    return (c.RobustWav2Vec2Config if robust else c.Wav2Vec2Config)(**{**TINY, **kw})


def port_pretraining_config(**kw):
    from gsoc_wav2vec2_tpu_torch.models import config as c

    return c.Wav2Vec2PretrainingConfig(**{**TINY_PRETRAINING, **kw})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv_of, world: int, timeout: float, env_extra=None):
    """Start `world` processes (`argv_of(rank)`) as the ranks of one group;
    returns the Popen objects (stdout+stderr piped)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])),
                   **(env_extra or {}))
        procs.append(subprocess.Popen(argv_of(rank), cwd=str(ROOT), env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def wait_all(procs, timeout: float):
    """Every process's (returncode, output); kills them all at the deadline
    and raises AssertionError with their output."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-2000:] for p in procs]
        raise AssertionError(f"ranks still running after {timeout} s:\n" + "\n---\n".join(tails))
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_ranks(case: str, world: int, kwargs: dict, tmp: Path, timeout: float = 120.0):
    """Run `case` as `world` ranks; returns their results (rank order)."""
    return run_groups([(case, world, kwargs, tmp)], timeout)[0]


def run_groups(jobs, timeout: float = 120.0):
    """Several independent process groups at once, `jobs` = [(case, world,
    kwargs, tmp)]; returns each group's results."""
    started = []
    for case, world, kwargs, tmp in jobs:
        Path(tmp).mkdir(parents=True, exist_ok=True)
        outs = [Path(tmp) / f"{case}-{world}-{r}.pt" for r in range(world)]
        # run by path: another installed package may own the name `tests`
        procs = launch(lambda r, o=outs, c=case, k=kwargs: [
            sys.executable, str(Path(__file__).resolve()), c, json.dumps(k), str(o[r])],
            world, timeout)
        started.append((procs, outs))
    results = []
    for procs, outs in started:
        for rank, (rc, out) in enumerate(wait_all(procs, timeout)):
            assert rc == 0, f"rank {rank} failed (rc {rc}):\n{out[-4000:]}"
        results.append([torch.load(o, weights_only=False) for o in outs])
    return results


# ---------------------------------------------------------------------------
# cases (each runs as a rank or, with no process group, as one process)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def no_attention_dropout():
    """Attention-prob dropout off while the hidden dropout stays on: the
    flash dropout seeds differ by shard (`seed + shard * 2**20`, as in
    JAX's mesh run), so only without them can a sharded run equal one
    process.  The draws are unchanged (the seed is still drawn)."""
    from gsoc_wav2vec2_tpu_torch.models import modeling

    mha = modeling.mha

    def without(*a, **kw):
        kw["dropout_rate"] = 0.0
        return mha(*a, **kw)

    modeling.mha = without
    try:
        yield
    finally:
        modeling.mha = mha


@contextlib.contextmanager
def gather_loss():
    """The step's contrastive loss in the `gather` formulation (the negatives'
    backward through `scatter_rows_add` on each rank's rows), where "auto"
    picks `gram`."""
    from gsoc_wav2vec2_tpu_torch.models import pretraining as pt

    loss = pt.pretraining_loss

    def gathered(*a, **kw):
        return loss(*a, **kw, contrastive_impl="gather")

    pt.pretraining_loss = gathered
    try:
        yield
    finally:
        pt.pretraining_loss = loss


@contextlib.contextmanager
def only_attention_dropout(seed: int):
    """Dropout inside attention alone, every layer's attention seed `seed`
    before the shard offset: the hidden-state dropout sites become the
    identity.  The JAX side of `test_torch_parallel_train.py` patches its
    model the same way, since its draws come from another generator."""
    from gsoc_wav2vec2_tpu_torch.models import modeling

    mha, drop = modeling.mha, modeling.dropout

    def fixed(*a, **kw):
        kw["seed"] = seed
        return mha(*a, **kw)

    modeling.mha, modeling.dropout = fixed, lambda x, *a, **kw: x
    try:
        yield
    finally:
        modeling.mha, modeling.dropout = mha, drop


def _ctc_batch(b: int, seed: int, masked: bool):
    rng = np.random.default_rng(seed)
    labels = np.zeros((b, 10), np.int32)
    for i in range(b):
        n = rng.integers(3, 8)
        labels[i, :n] = rng.integers(1, 32, size=n)
    batch = {"speech": rng.standard_normal((b, SAMPLES)).astype(np.float32), "labels": labels}
    if masked:
        am = np.ones((b, SAMPLES), np.int32)
        for i in range(1, b, 2):
            am[i, SAMPLES - 1000 * i:] = 0
        batch["attention_mask"] = am
    return batch


def _rows(batch: dict, rows: slice) -> dict:
    return {k: v[rows] for k, v in batch.items()}


def _nonzero_biases(model, seed: int) -> None:
    """Every bias drawn away from its zero init (the same on every rank), so
    that a row layer's bias added on each model rank, not once, shows."""
    gen = torch.Generator().manual_seed(seed + 1000)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))


def _equal_dicts(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _whole_grads(model, mesh):
    from gsoc_wav2vec2_tpu_torch.parallel.partition import unshard_state_dict

    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return {n: g.clone() for n, g in unshard_state_dict(grads, mesh).items()}


def ctc_train(mesh, batch=4, steps=2, accum=1, dropout=0.1, spec_augment=True, robust=False,
              masked=False, seed=0, lr=1e-3, grads_only=False, attention_seed=None):
    """A stage-2 fine-tune of the tiny model on `mesh` (data, model): `steps`
    updates of `accum` microbatches of `batch` global rows, hidden dropout
    and SpecAugment as asked, attention dropout off (with `attention_seed`:
    attention dropout alone, `only_attention_dropout`).  Returns the global
    losses and gradient norms, the first microbatch's logits (this rank's
    rows), its gradients (summed over the data group, whole tensors), whether
    the gather of the shards gives the whole model back, and the whole
    parameters after the updates.  `grads_only`: no optimizer update."""
    from gsoc_wav2vec2_tpu_torch.models import modeling
    from gsoc_wav2vec2_tpu_torch.parallel import batch_sharding, make_mesh, shard_params
    from gsoc_wav2vec2_tpu_torch.parallel.partition import unshard_state_dict
    from gsoc_wav2vec2_tpu_torch.training import state as st
    from gsoc_wav2vec2_tpu_torch.training import trainer

    m = make_mesh(*mesh)
    cfg = port_config(robust=robust, dropout=dropout, apply_spec_augment=spec_augment,
                      mask_time_prob=0.2, mask_time_length=3)
    model = modeling.Wav2Vec2ForCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    _nonzero_biases(model, seed)
    whole = {n: t.clone() for n, t in model.state_dict().items()}
    shard_params(model, m)
    roundtrip = _equal_dicts(unshard_state_dict(model.state_dict(), m), whole)
    st.set_trainable(model, ("feature_extractor",))
    state = st.create_train_state(model, st.create_optimizer(model, lr),
                                  generator=torch.Generator().manual_seed(seed + 1))
    kw = dict(division_factor=batch * accum, with_attention_mask=masked, length_aware=masked,
              remat=False, mesh=m)
    rows = batch_sharding(m, batch)
    out = {"loss": [], "grad_norm": [], "roundtrip": roundtrip}
    with (no_attention_dropout() if attention_seed is None
          else only_attention_dropout(attention_seed)):
        if grads_only:
            b = _rows(_ctc_batch(batch, seed + 2, masked), rows)
            with torch.no_grad():  # the loss below draws the same bits again
                logits = modeling.wav2vec2_for_ctc_forward(
                    model, cfg, torch.from_numpy(b["speech"]),
                    torch.from_numpy(b["attention_mask"]) if masked else None,
                    training=True, generator=torch.Generator().manual_seed(seed + 1), mesh=m)
            loss = trainer.make_ctc_loss_fn(cfg, **kw)(
                model, b, torch.Generator().manual_seed(seed + 1))
            loss.backward()
            trainer.all_reduce_grads(model, m)
            return {"logits": logits.detach(), "rows": (rows.start, rows.stop),
                    "loss": float(trainer.data_sum(loss.detach(), m)),
                    "grad_norm": float(trainer.grad_norm(model, m)),
                    "grads": _whole_grads(model, m), "roundtrip": roundtrip}
        if accum == 1:
            step = trainer.make_train_step(cfg, **kw)
        else:
            init_fn, accum_fn, apply_fn = trainer.make_grad_accum_steps(cfg, **kw)
        for i in range(steps):
            if accum == 1:
                state, metrics = step(state, _rows(_ctc_batch(batch, seed + 2 + i, masked), rows),
                                      state.generator)
            else:
                acc = init_fn(state)
                for j in range(accum):
                    b = _rows(_ctc_batch(batch, seed + 100 * i + j, masked), rows)
                    acc = accum_fn(state, b, state.generator, acc)
                state, metrics = apply_fn(state, acc)
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
    out["params"] = {n: t.clone() for n, t in unshard_state_dict(model.state_dict(), m).items()}
    return out


def _pretrain_batch(cfg, b: int, seed: int):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((b, SAMPLES)).astype(np.float32)
    am = np.ones((b, SAMPLES), np.int32)
    frames = int(cfg.conv_output_length(SAMPLES))
    mti = rng.random((b, frames)) < 0.5
    mti[:, :2] = True
    for i in range(1, b, 2):  # ragged rows, masks inside the real frames
        am[i, 5000:] = 0
        speech[i, 5000:] = 0.0
        mti[i, int(cfg.conv_output_length(5000)):] = False
    return {"speech": speech, "attention_mask": am, "mask_time_indices": mti}


def pretrain_train(mesh, batch=4, steps=2, dropout=0.1, seed=0):
    """`steps` pretraining updates of the tiny model on `mesh` (AdamW, every
    parameter trainable, ragged batches with their sample masks, hidden
    dropout and the Gumbel noise on, attention dropout off, the `gather`
    loss).  Returns the
    global metrics of each update and the whole parameters."""
    from gsoc_wav2vec2_tpu_torch.models import pretraining as pt
    from gsoc_wav2vec2_tpu_torch.parallel import batch_sharding, make_mesh, shard_params
    from gsoc_wav2vec2_tpu_torch.parallel.partition import unshard_state_dict
    from gsoc_wav2vec2_tpu_torch.training import state as st

    m = make_mesh(*mesh)
    cfg = port_pretraining_config(dropout=dropout)
    model = pt.Wav2Vec2ForPreTraining(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(seed))
    _nonzero_biases(model, seed)
    shard_params(model, m)
    st.set_trainable(model, ())
    state = st.create_train_state(model, st.create_pretrain_optimizer(model, 1e-3),
                                  generator=torch.Generator().manual_seed(seed + 1))
    step = pt.make_pretrain_step(cfg, division_factor=batch, with_attention_mask=True,
                                 remat=False, mesh=m)
    rows = batch_sharding(m, batch)
    metrics = []
    with no_attention_dropout(), gather_loss():
        for i in range(steps):
            state, got = step(state, _rows(_pretrain_batch(cfg, batch, seed + 2 + i), rows),
                              state.generator, 2.0)
            metrics.append({k: float(v) for k, v in got.items()})
    return {"metrics": metrics,
            "params": {n: t.clone() for n, t in unshard_state_dict(model.state_dict(), m).items()}}


def multihost_helpers():
    """The lockstep helpers with uneven streams (JAX
    `tests/test_multiprocess_distributed.py:82-292`)."""
    from gsoc_wav2vec2_tpu_torch.data.loaders import CommonDataLoader
    from gsoc_wav2vec2_tpu_torch.parallel import make_mesh, multihost

    rank = multihost.rank()
    out = {"run_id": multihost.sync_run_id(f"host-{rank}-id")}
    n = 3 - rank  # rank 0 has 3 batches, rank 1 has 2
    local = {"x": np.full((2, 3), float(rank), np.float32)}
    out["flag_steps"] = len(list(multihost.lockstep_batches(iter([local] * n))))
    out["counted_steps"] = len(list(multihost.lockstep_batches(iter([local] * n),
                                                               num_batches=n)))
    out["min_count"] = multihost.sync_min_count(n)
    out["min_none"] = multihost.sync_min_count(None)
    mesh = make_mesh(model=1)
    from gsoc_wav2vec2_tpu_torch.parallel import replicated

    same = torch.arange(6.0)
    out["replicated_same"] = torch.equal(replicated(mesh, same), same)
    try:
        replicated(mesh, same + rank)
        out["replicated_differs_refused"] = False
    except ValueError:
        out["replicated_differs_refused"] = True
    multihost.host_local_batch_to_global(local, mesh, global_batch=4)
    try:
        multihost.host_local_batch_to_global(local, mesh, global_batch=6)
        out["uneven_refused"] = False
    except ValueError:
        out["uneven_refused"] = True
    # bucketed: the ranks' bucket orders diverge (rank 0 flushes 1000 first)
    loader = CommonDataLoader(batch_size=2, buffer_size=16, audio_pad_id=0, labels_pad_id=0,
                              audio_maxlen=2000, labels_maxlen=8, bucket_boundaries=[1000, 2000])
    rng = np.random.default_rng(100)
    lens = (800, 900, 1800, 1900, 1700, 1600, 850, 950)
    audios = [rng.standard_normal(k).astype(np.float32) * 0.1 for k in lens]
    labels = [rng.integers(1, 31, 4).astype(np.int32) for _ in lens]
    mine = range(4 * rank, 4 * rank + 4)
    stream = loader.batchify(iter([(audios[i], labels[i]) for i in mine]), seed=None,
                             drop_remainder=True)
    batches = list(multihost.lockstep_bucket_batches(stream, repad=loader.repad_batch))
    out["bucket_shapes"] = [int(b["speech"].shape[1]) for b in batches]
    out["bucket_masks"] = [b["attention_mask"].sum(axis=1).tolist() for b in batches]
    return out


EVAL_LENS = (800, 1800, 900, 1700, 1900, 850)
EVAL_TEXTS = ["HELLO WORLD", "A B C", "THE CAT", "DOG RAN", "X Y", "OK THEN"]


def eval_corpus():
    rng = np.random.default_rng(7)
    return [(rng.standard_normal(n).astype(np.float32), t) for n, t in zip(EVAL_LENS, EVAL_TEXTS)]


def eval_wer(shard: bool = True, robust: bool = True):
    """Bucketed and padded WER of a tiny model over `eval_corpus()`: rank 0
    evaluates the first five samples and rank 1 the last, so rank 1's
    stream runs dry first and lockstep pads it with dummy batches; each
    sample's transcript by its length, and the number of dummy batches.
    `robust` False: the base family, whose conv0 GroupNorm spans the padding,
    so a sample decodes as in one process only at its own bucket."""
    from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator
    from gsoc_wav2vec2_tpu_torch.models import modeling
    from gsoc_wav2vec2_tpu_torch.parallel import make_mesh, multihost

    model = modeling.Wav2Vec2ForCTC(port_config(robust=robust), device="cpu",
                                    generator=torch.Generator().manual_seed(1))
    corpus = eval_corpus()
    mesh = make_mesh(model=1)
    if multihost.world_size() > 1:
        corpus = corpus[:5] if multihost.rank() == 0 else corpus[5:]
    ev = GreedyCTCEvaluator(model, mesh=mesh if shard else None)
    texts, dummies = {}, []
    predict = ev.predict_batch

    def recording(speech, lengths=None):
        out = predict(speech, lengths)
        real = [(int(n), t) for n, t in zip(lengths, out) if int(n) in EVAL_LENS]
        texts.update(real)
        if not real:
            dummies.append(1)
        return out

    ev.predict_batch = recording
    score, n = ev.evaluate_bucketed(iter(corpus), batch_size=2, buckets=[1000, 2000])
    bucketed_texts, bucketed_dummies, texts, dummies = texts, len(dummies), {}, []
    padded = ev.evaluate_padded(iter(corpus), batch_size=2, pad_to=2000)
    return {"wer": score, "n": n, "padded": padded, "texts": bucketed_texts,
            "padded_texts": texts, "dummies": [bucketed_dummies, len(dummies)]}


def cli_train(argv, sigterm_rank=None, sigterm_after=None):
    """`cli.train.main(parse_args(argv))`; with `sigterm_rank`, that rank
    sends itself SIGTERM after its `sigterm_after`-th update (the other
    ranks get no signal).  Returns the run directory and the final weights
    (None when the run stopped before `final/`)."""
    import signal

    from gsoc_wav2vec2_tpu_torch.cli import train
    from gsoc_wav2vec2_tpu_torch.parallel import multihost

    real = train.make_train_step
    if sigterm_rank is not None and multihost.rank() == sigterm_rank:
        def make_step(*a, **kw):
            step, calls = real(*a, **kw), []

            def counted(state, batch, gen):
                out = step(state, batch, gen)
                calls.append(1)
                if len(calls) == sigterm_after:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            return counted

        train.make_train_step = make_step
    try:
        args = train.parse_args(argv)
        train.main(args)
    finally:
        train.make_train_step = real
    final = os.path.join(args.ckpt_dir, "final")
    weights = None
    if os.path.isdir(final):
        from gsoc_wav2vec2_tpu_torch.models.modeling import Wav2Vec2ForCTC

        weights = Wav2Vec2ForCTC.from_pretrained(final, device="cpu").state_dict()
    return {"run_dir": args.ckpt_dir, "final": weights}


def card_base(mesh, steps=2, batch=4, samples=32000):
    """On the card (bf16, the kernels): a base-width model of 2 layers (768-d,
    12 heads), its eval logits and `steps` stage-2 updates on `mesh`
    (dropout 0.1, SpecAugment, attention dropout off).  Returns the logits
    (this rank's rows), global losses, whole parameters before and after,
    and the kernel launches of the run."""
    from gsoc_wav2vec2_tpu_torch.models import config as c
    from gsoc_wav2vec2_tpu_torch.models import modeling
    from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend, flash_attention, pos_conv
    from gsoc_wav2vec2_tpu_torch.parallel import batch_sharding, make_mesh, shard_params
    from gsoc_wav2vec2_tpu_torch.parallel.partition import unshard_state_dict
    from gsoc_wav2vec2_tpu_torch.training import state as st
    from gsoc_wav2vec2_tpu_torch.training import trainer

    m = make_mesh(*mesh)
    dev = torch.device("cuda", 0)
    counters = (conv_frontend.conv01, pos_conv.pos_conv, pos_conv.pos_conv_train_fwd,
                flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd)
    for f in counters:
        f.launches = 0
    cfg = c.Wav2Vec2Config(num_layers=2)
    model = shard_params(modeling.Wav2Vec2ForCTC(cfg, device=dev,
                                                 generator=torch.Generator().manual_seed(0)), m)
    rng = np.random.default_rng(5)
    rows = batch_sharding(m, batch)
    x = torch.from_numpy(rng.standard_normal((batch, samples)).astype(np.float32))[rows].to(dev)
    with torch.inference_mode():
        logits = modeling.wav2vec2_for_ctc_forward(model, cfg, x, compute_dtype=torch.bfloat16,
                                                   mesh=m).float().cpu()
    st.set_trainable(model, ("feature_extractor",))
    whole = lambda: {n: t.float().cpu().clone() for n, t in unshard_state_dict(  # noqa: E731
        {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, m).items()}
    p0 = whole()
    state = st.create_train_state(model, st.create_optimizer(model, 1e-4),
                                  generator=torch.Generator().manual_seed(1))
    step = trainer.make_train_step(cfg, division_factor=batch, remat=False, mesh=m)
    losses = []
    labels = np.zeros((batch, 20), np.int64)
    labels[:, :12] = rng.integers(1, 32, size=(batch, 12))
    with no_attention_dropout():
        for i in range(steps):
            speech = rng.standard_normal((batch, samples)).astype(np.float32)
            state, metrics = step(state, {"speech": speech[rows], "labels": labels[rows]},
                                  state.generator)
            losses.append(float(metrics["loss"]))
    return {"logits": logits, "rows": (rows.start, rows.stop), "loss": losses, "p0": p0,
            "params": whole(), "launches": [f.launches for f in counters]}


def cli_train_error(argv):
    """`cli.train.main(parse_args(argv))`, which must raise ValueError: its
    message (None when it ran)."""
    from gsoc_wav2vec2_tpu_torch.cli import train

    try:
        train.main(train.parse_args(argv))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def cli_pretrain(argv):
    """`cli.pretrain.main(parse_args(argv))`: the run's logged metrics (rank
    0's file) and whether `for_ctc/` was written."""
    from gsoc_wav2vec2_tpu_torch.cli import pretrain

    args = pretrain.parse_args(argv)
    pretrain.main(args)
    metrics = os.path.join(args.log_dir, "metrics.jsonl")
    logged = [json.loads(line) for line in open(metrics)] if os.path.exists(metrics) else []
    return {"logged": logged,
            "exported": os.path.isdir(os.path.join(args.ckpt_dir, "for_ctc"))}


def cli_evaluate(argv):
    """`cli.evaluate.main(argv)`: its report."""
    from gsoc_wav2vec2_tpu_torch.cli import evaluate

    return evaluate.main(argv)


CASES = {"ctc_train": ctc_train, "card_base": card_base, "cli_evaluate": cli_evaluate,
         "cli_pretrain": cli_pretrain, "pretrain_train": pretrain_train,
         "multihost_helpers": multihost_helpers, "eval_wer": eval_wer, "cli_train": cli_train,
         "cli_train_error": cli_train_error}


def _main() -> None:
    case, kwargs, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    from gsoc_wav2vec2_tpu_torch.parallel import multihost

    # card cases: both ranks share cuda:0, so the backend rule picks gloo
    multihost.initialize("cuda:0" if case.startswith("card_") else "cpu", timeout_s=120)
    try:
        torch.save(CASES[case](**kwargs), out)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    _main()

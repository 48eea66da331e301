"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card    -- device name and `nvidia-smi` name / power limit;
  2. build   -- the CUDA kernels built from `gsoc_wav2vec2_tpu_torch/csrc`;
  3. kernels -- each kernel against its plain PyTorch version at the main
                paths' shapes (base inference: B=16 x 246000 samples; base
                training: B=32 x 246000; long: 1 x 1,920,000 samples = 5999
                frames, attention also at 8192 and 32768 frames; those of
                the robust/large shapes open phase 7), with its time a
                call (CUDA events over a back-to-back run), the plain
                version's, a PyTorch library call's (a yardstick the port
                never calls) and the card's bound; the flash kernels also
                with the profiler's device time, the bound of their
                exponentials and the library's kernel names; the CTC
                kernels (forward; backward = adjoint + per-class sums) at
                32 x 768 frames, V = 32, labels 50-200, 8 rows short and one
                infeasible (its loss finite, >= 1e4), at a data-2 rank's 16
                x 768, at 1 x 5999 frames, at 4 x 400 frames of an
                8192-class vocabulary and at the widest label row of each
                kernel instance, against `ctc_loss_plain` (loss rtol 1e-5,
                gradient atol 1e-5, two launches bit-equal), a row of 2049
                label positions refused on the card, the kernels' log1p
                bit-equal to log1pf on [0, 1], timed beside `F.ctc_loss`'s
                forward and its backward alone (the forward no slower at 16
                x 768), with the profiler's device ms and the chain bound
                (frames x one frame's critical path, timed on the card);
  4. main    -- full-width, full-depth base `Wav2Vec2ForCTC` from seeded
                weights: a bf16 batch through `GreedyCTCEvaluator`, three
                requests of different lengths, one 40 s clip through
                `transcribe_long`; launch counts per forward; two forwards
                of the batch bit-equal; the card's logits against an f32
                CPU copy of the model;
  5. profile -- device time by kernel over three forwards; then the JAX
                tests' tiny_config, which no kernel instance covers: a bf16
                batch and a stage-2 step through the plain ops (every kernel
                count 0) and an f32 forward against the f32 CPU copy;
  6. train   -- the same model with the recipe's regularisation (dropout
                0.1, SpecAugment): one stage-1 step and 6 stage-2 steps of
                `make_train_step` at B=32 x 246000; launch counts per
                stage-2 step, step time, peak memory; then one
                deterministic stage-2 loss + gradient on the card (bf16)
                against a second, bit-equal forward backed through the
                plain attention backward and against the f32 CPU copy;
                6b: the card's `layer_norm` (one fused `F.layer_norm`)
                against `layer_norm_plain` (the JAX package's sequence of
                operations, which the CPU runs): f32 output and gradient,
                bf16 output; both timed (device ms, host enqueue ms,
                kernels a call) at the served, inference and train shapes;
  7. robust  -- the robust/large family at full width and depth (1024-d, 24
                pre-norm layers, 16 heads, LayerNorm conv stack), seeded
                weights: its kernels as in phase 3 (B=8 x 246000: conv front
                end with LayerNorm, pos conv at 64 channels a group, attention
                at 16 heads), then a ragged B=8 x 246000 batch through
                `GreedyCTCEvaluator.predict_batch` (sample mask on every
                call), `evaluate_bucketed` over 24 utterances of mixed
                length, a timed and a profiled forward, one row's logits
                against the f32 CPU copy; then one stage-1 and 4 stage-2
                steps at B=8 x 246000 with dropout 0.1, SpecAugment and the
                mask; exact launch counts per forward and per step;
  8. long    -- 120 s of audio in one pass (base width, 4 layers): one
                utterance of 1,920,000 samples (5999 frames) through
                `predict_batch` and through a stage-2 step with dropout
                0.1, each held against the same path through the plain
                versions on the card; the step's device time by kernel and
                the CTC kernels' share of it;
  9. pretrain -- `scatter_rows_add` against its plain version at
                (8, 76800, 256) and (8, 76800, 768) -> 768 rows, f32 and bf16, on
                indices from `sample_negative_indices` over a `batch_masks`
                mask of a ragged batch (so row 0 is hot), bit-equal over two
                launches; then the full base `Wav2Vec2ForPreTraining` (768-d,
                12 layers, codebooks 2 x 320, 100 negatives), every parameter
                trainable, ragged B=8 x 246000 with its mask: 1 + 6 steps of
                `make_pretrain_step` (AdamW, warmup schedule, Gumbel
                temperature anneal; `gram` loss), exact launch counts per step
                (the fused front end kernels 0), a profiled step; then
                `pretrain_gather`: one forward, the loss backed through three
                times (`gather` with the scatter kernel, `gather` with
                autograd's index backward, `gram`), held against each other;
                then one deterministic pretraining loss in bf16 on the card
                against the f32 CPU copy;
 10. cli     -- the command-line path at full base width (768-d, 12 layers,
                the recipe's dropout 0.1 and SpecAugment): (a) `save_pretrained`
                of the seeded model, `from_pretrained` onto the card, bf16
                logits of the B=16 batch bit-equal to the in-memory model's;
                (b) a synthetic corpus of 96 utterances (160000-246000
                samples, 50-200 label ids) written with the port's
                `TFRecordWriter`, 64 to train and 32 to validate; (c)
                `cli.train.main` with the recipe's batch of 32 x 246000: one
                stage-1 epoch and two stage-2 epochs (2 updates an epoch), a
                checkpoint and a validation loss every epoch, exact launch
                counts per update and per validation pass, the loader's host
                ms per batch against the update's ms, one stage-2 epoch under
                the profiler, and whether two identical stage-2 updates give
                bit-equal gradients; (d) the same recipe with one stage-2
                epoch, its last checkpoint restored bit for bit, then
                `--resume` to two epochs (exactly two stage-2 updates, logged
                as steps 3 and 4), held against (c): two identical updates'
                gradients, two straight runs and the resume bit-equal (the
                CTC kernels are deterministic), and the median
                update-relative L2 difference within `RESUME_MEDIAN_TOL`,
                which a resume with a planted fault (a fresh generator) must
                exceed; (e) `cli.evaluate` on (c)'s `final/` over the
                validation shard in bucketed and single mode (32 samples,
                launch counts a forward); (f) `cli.pretrain.main` at full
                base width and depth (default `--remat --remat_policy
                dots`) on (b)'s training shards: 2 epochs of 2 updates (4
                microbatches of 8), EMA, launch counts of the run, finite
                losses, an annealing temperature, `for_ctc/` and
                `for_ctc_ema/` loaded onto the card with finite logits and
                one head; a SIGTERM after update 3, `--resume` to the end;
                the resumed exports against the straight run's (reported);
                updates a second and the loader's host ms.  `cli.train`
                runs its default remat "dots": 24 attention forwards a
                stage-2 update.
 11. serve   -- the HTTP server at full base width (768-d, 12 layers, random
                seed 0): `save_pretrained`, then `cli.serve`'s own argument
                parsing and loading onto the card; a `DynamicBatcher` with
                the defaults (buckets 32000 / 64000 / 123000 / 246000,
                max_batch 8, 20 ms window), its warmup (each bucket's first
                forward timed), `make_handler` on a `ThreadingHTTPServer` at
                127.0.0.1:0 in a thread of this process; the four kernels
                against their plain versions at each bucket's batch shape;
                `serve_bench.run_load` with 8 clients and 64 requests of WAV
                bytes cycling serve_bench's four lengths, then the 1-client
                baseline: latency percentiles (client and server), requests
                and audio-seconds a second, mean `batched_with`, per layer the
                device ms of a forward at each bucket and the host ms of
                parsing, padding and decoding a dispatch, and exactly one
                forward's launches a dispatch.  Checks: (a) each served
                transcript equals the in-process decode of its audio alone in
                a (max_batch, bucket) batch, and a row moved with its
                neighbours changed gives bit-equal ids; (b) the "scored" and
                "logprobs" step modes give the "argmax" ids on the B=16 x
                246000 batch; (c) `?timestamps=1`: words joined equal the
                transcript, times monotonic and inside the audio; (d) a
                `/v1/stream` session (normalize "none") fed 40 s in 2 s pieces
                finishes with `transcribe_long`'s transcript; (e) `/v1/align`
                of a served transcript: one segment per word, inside the audio;
                (f) beam search (width 8, a char 4-gram LM fit on random ids)
                over the B=16 batch's log-probs, its host ms against the
                forward's.
 12. remat   -- remat off, "full" and "dots" (`encoder_forward(remat=...)`)
                on the base stage-2 step at B=32 x 246000 and on pretraining
                (base B=8 and B=16, robust/large B=8) x 246000: one warm-up
                and 3 timed steps each from the same weights and seed, ms a
                step, peak memory, exact launch counts (remat: 2 attention
                forwards a layer), the parameters after one step bit-equal
                across the three.
 13. hubert  -- a raw HF snapshot of facebook/hubert-large-ls960-ft's
                architecture (config.json, pytorch_model.bin under `hubert.`
                names, seed 1) through `from_pretrained` onto the card, bit
                for bit; a ragged B=8 x 246000 batch through `predict_batch`;
                launches a forward (`conv01_robust` 1, `pos_conv` 1, flash
                24); ms a forward; row 0 against the f32 CPU forward (10% of
                the logit scale, argmax >= 90%).
 13b. xlarge -- the 1280-d family (HuBERT-xlarge, XLS-R 1B, MMS-1B): a raw HF
                snapshot of facebook/hubert-xlarge-ls960-ft's architecture
                (1280-d, its 48 layers cut to 24 for the time limit, 16
                heads of 80, pos conv 16 groups of 80, seed 1) through
                `from_pretrained` onto the card, bit for bit; a ragged B=8 x 246000 batch through `predict_batch`: launches a
                forward (`conv01_robust` 1, `pos_conv` 1, flash 0: no flash
                instance at head dim 80, as in JAX), ms a forward, row 0
                against the card's plain f32 forward (10% of the logit scale,
                argmax >= 90%); the four pos-conv kernels at C/G = 80 and (8,
                768, 1280) against their plain versions, timed, with the
                library's grouped conv beside them; one stage-1 and 4 stage-2
                steps of the batch (dropout 0.1, SpecAugment, the mask;
                `cli.train`'s default remat "dots"; the three pos-conv
                training kernels and the CTC pair 1 each a step), ms a step,
                peak memory, and two identical stage-2 gradients bit-equal.
 13c. xls_r_2b -- XLS-R 2B's 1920-d: facebook/wav2vec2-xls-r-2b's
                architecture (1920-d, its 48 layers cut to 24 as 13b's, 16
                heads of 120, FFN 7680, pos conv 16 groups of 120, ~2.16e9
                parameters at full depth) with a CTC head of vocab 32, seed
                1, built by the model's constructor (no snapshot); as 13b at
                C/G = 120 (flash 0: no flash instance at head dim 120, as in
                JAX), with 4 stage-2 steps under remat "full" (at full depth
                the f32 weights, gradients and Adam moments alone are ~34.6
                GB).
 13d. robust_h128 -- `RobustWav2Vec2Config(num_heads=8)`: facebook/
                wav2vec2-large-robust's widths (1024-d, 24 pre-norm layers,
                FFN 4096, pos conv 16 groups of 64) with 8 heads of 128, the
                one field that sets the head dim changed, vocab 32, seed 1:
                first the flash kernels' D = 128 instances against their
                plain versions (forward 0.02, with dropout 0.04, gradients
                1% of their scale; every launch twice, bit-equal) at (8, 8,
                768, 128) with a ragged bias, without and with dropout 0.1,
                at (1, 8, 5999, 128) with dropout and at the tile edges L =
                1, 63, 64, 65, 127, 128, 129, 1249, timed beside their
                bounds and SDPA; then as 13b at C/G = 64 with the flash
                kernels: launches a forward `conv01_robust` 1, `pos_conv` 1,
                flash 24; ms a forward, and once with the flash kernels
                turned off through `supports` (the plain attention); row 0
                against the card's plain f32 forward; 1 + 4 stage-2 steps
                without remat (flash forward 24 and backward 24 a step).
 13e. base_h192, robust_h256 -- the flash kernels' D = 192 and 256
                instances, checked and timed as 13d's at (16, 4, 768, 192)
                and (8, 4, 768, 256), at (1, 4, 5999, D) and at the tile
                edges; then `Wav2Vec2Config(num_heads=4)` (base width, 12
                post-norm layers, 4 heads of 192, seed 1) on B=16 x 246000
                through `predict_batch` (`groupnorm_stats`, `fused_conv01`,
                `pos_conv` 1 each, flash 12 a forward), row 0 against the
                card's plain f32 forward (5% of the logit scale), its
                front-end, pos-conv and flash kernels held at B=8, 1 + 4
                stage-2 steps at B=8 (flash 12 + 12 a step); and
                `RobustWav2Vec2Config(num_heads=4)` (4 heads of 256) as 13d.
 13f. conv_widths, base_c384, robust_c1024 -- every conv01 instance (C =
                128, 256, ..., 1024, both families) against its plain
                version at (8, 246000) and at T1 = 1, 63, 64, 65, 129 (0.05,
                mean 5e-3), launched twice bit-equal, timed beside its plain
                version, the library chain and its bound; `groupnorm_stats`
                at 384 and 1024; then `Wav2Vec2Config(filter_sizes=[384] *
                7)` (base width, 12 layers, seed 1) on B=16 x 246000 through
                `predict_batch` (`groupnorm_stats`, `fused_conv01` (C = 384),
                `pos_conv` 1 each, flash 12 a forward; its front end held
                at B=16 and 8 and flash at (8, 12, 768, 64) first) and
                `RobustWav2Vec2Config(filter_sizes=[1024] * 7)` (24 layers)
                on a ragged B=8 batch with its mask (`conv01_robust` (C =
                1024) 1, `pos_conv` 1, flash 24): ms a forward, and with the
                front-end kernels off (the plain layer loop); row 0 against
                the card's plain f32 forward (5% / 10% of the logit scale);
                1 + 3 stage-2 steps at B=8; two stage-2 gradients bit-equal.
 13g. pos_widths, base_g8, robust_g8 -- the four pos-conv kernels' C/G =
                32, 96, 112 and 128 instances against their plain versions
                at (8, 768, 16 C/G), K = 128, 16 groups, and at 2 x 3000, 1
                x 63 and 3 x 129 with K = 16 (at 128 also K = 132),
                launched twice bit-equal, timed beside the plain versions,
                the library calls and the bound; then
                `Wav2Vec2Config(num_conv_pos_embedding_groups=8)` (base
                width, C/G = 96, seed 0) on B=16 x 246000 and
                `RobustWav2Vec2Config(num_conv_pos_embedding_groups=8)` (24
                layers, C/G = 128) on a ragged B=8 batch with its mask, each
                model's pos conv first held at its paths' shapes: ms a
                forward, and with the pos-conv kernels off (the plain
                conv); row 0 against the card's plain f32 forward (5% / 10%
                of the logit scale); 1 + 3 stage-2 steps at B=8; two
                stage-2 gradients bit-equal.
 13h. pos_odd8, base_g32, robust_g128 -- the same at the odd multiples of
                8 below 128 (C/G = 8, 24, 40, 56, 72, 88, 104: the
                contraction padded to whole k steps), then
                `Wav2Vec2Config(num_conv_pos_embedding_groups=32)` (C/G =
                24) and `RobustWav2Vec2Config(num_conv_pos_embedding_
                groups=128)` (C/G = 8) as 13g's two models.
 13i. f32    -- `--compute_dtype float32` (TF32 off): the flash kernels'
                f32 instance at head dim 64 (`flash_attention_f32.cu`)
                against its plain versions (out and lse 1e-4, gradients 1e-3
                and 1e-4 of their scale, every launch twice bit-equal) at
                the tile edges, at (16, 12, 768, 64) with a ragged bias,
                dropout 0 and 0.1, and at (1, 12, 5999, 64) with dropout,
                timed beside their bound (494.7 TFLOP/s TF32 / 3), the plain
                versions and SDPA in f32; then `Wav2Vec2Config()` (B=16 x
                246000) and `RobustWav2Vec2Config()` (ragged B=8 with its
                mask) at full width and depth in f32 through
                `predict_batch` (flash forward 12 / 24 a forward, no other
                kernel), ms a forward beside the plain attention's, row 0
                against the card's plain f32 forward (4e-3); one stage-2
                step each at B=8 (dropout 0.1, SpecAugment; flash forward
                and backward one a layer, CTC 1 + 1), two identical
                stage-2 gradients bit-equal under the training CLIs' own
                setting (`training.deterministic_training`), the gradients
                that differ under cuDNN's defaults recorded; the kernels
                also at std-6 scores on (1, 2, 8192, 64) under the relative
                gradient bound.
 13j. f32_wide -- 13i at head dims 128, 192 and 256
                (`flash_attention_f32_wide.cu`, TF32 wgmma): first the TF32
                probe (the card's wgmma reads f32 operands truncated, the A
                operand where the kernels put it), then the kernels at (8,
                8, 768, 128) and (8, 4, 768, 256) with a ragged bias and
                (16, 4, 768, 192) without, the long regime and the tile
                edges of their 64-row blocks and 32-row tiles at each; then `RobustWav2Vec2Config(num_heads=8)` (ragged B=8),
                `Wav2Vec2Config(num_heads=4)` (B=16) and
                `RobustWav2Vec2Config(num_heads=4)` (ragged B=8) at full
                width and depth in f32 as 13i's two models (flash 24 / 12 /
                24 a forward and a stage-2 step).
 14. export  -- `cli.export.main` at base width and depth: `torch_export` on
                the card (symbolic batch, 246000 samples), the program run
                in a process that imports `ops.kernels` alone (no model
                code) at B=16 and B=3: launches a forward equal to a live
                forward's, logits bit-equal to the live module's (else held
                at 5% of the logit scale); ms a forward beside the live
                one's; then `onnx` at 32000 samples, evaluated by
                `onnx_numpy` on the host against the f32 CPU forward (atol
                1e-3).
 15. profiling -- `timeit` of the base forward at its defaults (3 warmup
                calls, 20 timed back to back, one readback) against the
                card's own span of the same 20 calls (CUDA events recorded
                before the first timed call and after the last), 11
                rounds: the median relative difference within 3.5%; by
                turns with it, printed for the record, the host-clock ms
                of 20 forwards back to back ended by one synchronize, over
                20 (the two in alternating order from round to round), and
                phase 4's method (the median of 20 synchronised calls)
                beside phase 4's median; then
                `utils.profiling.trace` around an unannotated forward and
                one inside `annotate("w2v2_forward")`: the kernels that ran
                in the region include the four inference kernels.
 16. dist    -- data and tensor parallelism (`parallel/`) as two ranks on
                the one card, each a fresh interpreter of this script
                (`--dist-worker`; torchrun's environment, a port from a
                freshly bound socket): the backend rule gives gloo (NCCL
                refuses two ranks on one device), each rank has a deadline
                and a 120 s group timeout, and a failure prints each rank's
                last 40 stderr lines.  First the kernels at the ranks' own
                shapes against their plain versions, timed (flash forward and
                backward at (16, 6, 768, 64) and (16, 12, 768, 64) under a
                shard seed, the pos conv's training kernels at 16 rows, the
                CTC kernels at 16 x 768); then, at full base width on phase
                10's corpus: (a) `cli.train` stage 2 at data 2 (32 x 246000,
                16 rows a rank) and (b) at `--model_axis 2` (16 x 246000, 6
                heads and FFN 1536 a rank), 2 updates each, the first
                update's loss and gradient norm against one process on the
                same global batch (attention dropout off in both: its shard
                seeds differ from one process's) within `DIST_BOUNDS`, the
                checkpoint and `final/` whole tensors that load in one
                process; (c) `cli.pretrain` at data 2 with the `gather` loss
                (8 rows a rank, 4 updates): finite, `scatter_rows_add` on
                each rank every update; (d) `cli.evaluate --sharded` over 17
                records (9 and 8: rank 1 runs a dummy batch) with the
                transcripts and WER of one process.  Per case the backend,
                ms an update on two ranks and on one, the collectives' share
                of an update and each rank's exact launches.
 17. serve_sharded -- `cli.serve --sharded` as two ranks on the one card
                (fresh interpreters as in phase 16, rank 0 the leader that
                binds the port), serving phase 11's model with `cli.serve`'s
                defaults: the four inference kernels against their plain
                versions at a rank's (4, 246000); the log-probs of (8,
                bucket) rows against the same rows as two (4, bucket)
                batches (gap reported); `serve_bench`'s bodies at 8 clients
                x 16, then 1 x 8, a timestamped request, an alignment and a
                40 s stream, every reply equal to phase 11's (word
                confidences within 0.02); every dispatch one forward of each
                rank's block (4 rows; 1 for the single-row dispatches) with
                exact launches; latency percentiles, audio-s a second, the
                broadcast-and-gather ms of a dispatch and its share, the
                leader's idle share; a SIGTERM to the leader stops both
                ranks with exit code 0.
The train, robust, long and pretrain phases pass `remat=False`, so that
their rows compare with earlier runs.
Then the `kernels` line (every kernel's record), the card line and, last,
{"ok": true, "device": {...}}.  Any failure raises and the script exits
non-zero without that line; without CUDA it exits at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import inspect
import json
import math
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import re
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from gsoc_wav2vec2_tpu_torch import (
    GreedyCTCEvaluator,
    RobustWav2Vec2Config,
    RobustWav2Vec2PretrainingConfig,
    Wav2Vec2Config,
    Wav2Vec2ForCTC,
    Wav2Vec2ForPreTraining,
    Wav2Vec2PretrainingConfig,
)
from gsoc_wav2vec2_tpu_torch.cli import evaluate as evaluate_cli
from gsoc_wav2vec2_tpu_torch.cli import export as export_cli
from gsoc_wav2vec2_tpu_torch.cli import serve, serve_bench
from gsoc_wav2vec2_tpu_torch.cli import pretrain as pretrain_cli
from gsoc_wav2vec2_tpu_torch.cli import train as train_cli
from gsoc_wav2vec2_tpu_torch.cli.pretrain import PretrainingArgs, batch_masks, gumbel_temperature
from gsoc_wav2vec2_tpu_torch.cli.train import TrainingArgs
from gsoc_wav2vec2_tpu_torch.convert.hf_torch import hf_name_map
from gsoc_wav2vec2_tpu_torch.data import native_io
from gsoc_wav2vec2_tpu_torch.data.loaders import LibriSpeechDataLoader, LibriSpeechDataLoaderArgs
from gsoc_wav2vec2_tpu_torch.data.processor import Wav2Vec2Processor
from gsoc_wav2vec2_tpu_torch.decoding import CharNGramLM, ctc_prefix_beam_search
from gsoc_wav2vec2_tpu_torch.evaluation import default_buckets, plan_chunks
from gsoc_wav2vec2_tpu_torch.export.onnx_numpy import OnnxModel
from gsoc_wav2vec2_tpu_torch.models import pretraining as pt
from gsoc_wav2vec2_tpu_torch.models.config import config_from_hf_dict
from gsoc_wav2vec2_tpu_torch.models.modeling import wav2vec2_for_ctc_forward
from gsoc_wav2vec2_tpu_torch.ops import conv as conv_ops
from gsoc_wav2vec2_tpu_torch.ops.basic import layer_norm, layer_norm_plain
from gsoc_wav2vec2_tpu_torch.ops.ctc import ctc_loss_fn
from gsoc_wav2vec2_tpu_torch.ops.kernels import _build
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend as cf
from gsoc_wav2vec2_tpu_torch.ops.kernels import ctc as ctck
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as fa
from gsoc_wav2vec2_tpu_torch.ops.kernels import pos_conv as pc
from gsoc_wav2vec2_tpu_torch.ops.kernels import scatter_add as sa
from gsoc_wav2vec2_tpu_torch.training import (
    create_optimizer,
    create_pretrain_optimizer,
    create_train_state,
    deterministic_training,
    make_ctc_loss_fn,
    make_train_step,
    pretrain_lr_schedule,
    set_learning_rate,
    set_trainable,
)
from gsoc_wav2vec2_tpu_torch.training.checkpoint import CheckpointManager
from gsoc_wav2vec2_tpu_torch.utils import profiling
from gsoc_wav2vec2_tpu_torch.utils.logging import MetricLogger

from flash_bench import front_params

# Published H100 SXM peaks (dense): bf16 tensor cores, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # outside the tensor cores
PEAK_TF32 = 494.7e12  # dense TF32 tensor cores; an f32 product as three TF32 ones runs at a third
PEAK_BYTES = 3.35e12
HOST_CYCLES_PER_CALL = 1e6  # device clocks (~0.5 ms) of sleep per timed call: above any wrapper's host time
MUFU_EX2 = 132 * 16 * 1.98e9  # exp2 results a second: 16 a clock on each of 132 SMs at 1.98 GHz

B, SAMPLES = 16, 246000
TRAIN_B = 32  # the recipe's per-device batch (cli/train.py)
STAGE2 = ("feature_extractor",)
STAGE1 = ("wav2vec2",)
STAGE2_STEPS = 6
ROBUST_B = 8            # the JAX package's own large-model shape: B=8 x 246000
ROBUST_STAGE2_STEPS = 4
PRETRAIN_B = 8           # the pretraining CLI's per-device batch, x 246000 samples
PRETRAIN_STEPS = 6
LONG_SAMPLES = 1_920_000  # 120 s: 5999 frames, past 4096 and not a multiple of 128
LONG_LAYERS = 4
CSRC = "gsoc_wav2vec2_tpu_torch/csrc/"
PALLAS = "gsoc_wav2vec2_tpu/ops/pallas/"

# every kernel wrapper that counts its launches
KERNELS = {
    "groupnorm_stats": cf.groupnorm_stats, "fused_conv01": cf.conv01,
    "conv01_robust": cf.conv01_robust, "pos_conv": pc.pos_conv,
    "pos_conv_train_fwd": pc.pos_conv_train_fwd, "pos_conv_dx": pc.pos_conv_dx,
    "pos_conv_dw": pc.pos_conv_dw, "flash_attention_fwd": fa.flash_attention_fwd,
    "flash_attention_bwd": fa.flash_attention_bwd, "scatter_rows_add": sa.scatter_rows_add,
    "ctc_loss_fwd": ctck.ctc_loss_fwd, "ctc_loss_bwd": ctck.ctc_loss_bwd,
}
# the paths whose launches count for each family of records
BASE_PATHS = ("inference", "train", "long_inference", "long_train", "cli", "serve", "export",
              "base_h192", "base_h192_train")
ROBUST_PATHS = ("robust_inference", "robust_train", "hubert")
SHORT_PATHS = ("inference", "train") + ROBUST_PATHS + ("pretrain", "pretrain_gather", "cli", "serve",
                                                     "export",
                                                     "remat", "pretrain_cli")
TRAIN_PATHS = ("train", "pretrain", "pretrain_gather", "cli", "remat", "pretrain_cli")
CTC_PATHS = ("train", "robust_train", "long_train", "cli", "remat", "xlarge_train",
             "xls_r_2b_train", "robust_h128_train", "base_h192_train", "robust_h256_train",
             "base_c384_train", "robust_c1024_train", "base_g8_train", "robust_g8_train",
             "base_g32_train", "robust_g128_train")
# a CTC loss and its gradient: one launch of each wrapper
CTC_STEP = {"ctc_loss_fwd": 1, "ctc_loss_bwd": 1}
LONG_PATHS = ("long_inference", "long_train")
# the 1280-d family (phase 13b) and XLS-R 2B's 1920-d (phase 13c)
XLARGE_PATHS = ("xlarge", "xlarge_train", "xls_r_2b", "xls_r_2b_train")
# the robust/large widths at 8 heads of 128 (phase 13d), at 4 of 256 (13e)
H128_PATHS = ("robust_h128", "robust_h128_train")
H256_PATHS = ("robust_h256", "robust_h256_train")


def reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def counts_since(before: dict) -> dict:
    return {k: fn.launches - before[k] for k, fn in KERNELS.items()}


def expect_counts(what: str, got: dict, want: dict) -> None:
    """Exact launch counts: every wrapper not named in `want` must show 0."""
    full = {k: want.get(k, 0) for k in KERNELS}
    require(got == full, f"launches in {what}: {got} != {full}")


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (on the card), to hold
    a whole path through the kernels against the same path without them."""
    swaps = [(cf, "groupnorm_stats", cf.groupnorm_stats_plain), (cf, "conv01", cf.conv01_plain),
             (cf, "conv01_robust", cf.conv01_robust_plain), (pc, "pos_conv", pc.pos_conv_plain),
             (pc, "pos_conv_train_fwd", pc.pos_conv_train_fwd_plain),
             (pc, "pos_conv_dx", pc.pos_conv_dx_plain), (pc, "pos_conv_dw", pc.pos_conv_dw_plain),
             (fa, "flash_attention_fwd", fa.flash_attention_fwd_plain),
             (fa, "flash_attention_bwd", fa.flash_attention_bwd_plain),
             (sa, "scatter_rows_add", sa.scatter_rows_add_plain),
             (ctck, "ctc_loss_fwd", ctck.ctc_loss_fwd_plain),
             (ctck, "ctc_loss_bwd", ctck.ctc_adjoint_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def base_forward_counts(layers: int) -> dict:
    """Launches of one base-family bf16 forward (eval, or stage 1's training
    forward: no gradient reaches the backbone)."""
    return {"groupnorm_stats": 1, "fused_conv01": 1, "pos_conv": 1, "flash_attention_fwd": layers}


def base_step_counts(layers: int, remat: bool = False) -> dict:
    """Launches of one base-family stage-2 step (front end frozen); under
    remat each layer's attention forward runs again in the backward."""
    return {"groupnorm_stats": 1, "fused_conv01": 1, "pos_conv_train_fwd": 1, "pos_conv_dx": 1,
            "pos_conv_dw": 1, "flash_attention_fwd": layers * (2 if remat else 1),
            "flash_attention_bwd": layers, **CTC_STEP}


def pretrain_step_counts(layers: int, remat: bool = False) -> dict:
    """Launches of one pretraining step (the conv front end trains, so its
    fused kernels show 0)."""
    return {"pos_conv_train_fwd": 1, "pos_conv_dx": 1, "pos_conv_dw": 1,
            "flash_attention_fwd": layers * (2 if remat else 1), "flash_attention_bwd": layers}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around `iters` back-to-back calls
    after `warmup` calls, over `iters`.  A device-side sleep ahead of the run
    holds the stream while the host enqueues it, so the host's wrapper work
    is counted in no call, even where it outlasts a call's kernels (one
    pair of events around each call would count it in every call)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(iters * HOST_CYCLES_PER_CALL))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def exp_bound_ms(n_exp: float) -> float:
    """The least time for `n_exp` exponentials on the SFUs (MUFU.EX2)."""
    return n_exp / MUFU_EX2 * 1e3


def device_kernels(fn, reps: int = 5):
    """(device ms a call by the profiler, [kernel names by device time]) of
    `fn`: what a library call launched, and its kernels' time alone."""
    prof = profile_device(fn, reps, "call", top=4)
    return prof["device_busy_ms_per_call"], [k["kernel"] for k in prof["top"]]


def errors(got: torch.Tensor, want: torch.Tensor):
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item()


def profile_device(fn, reps: int, unit: str, top: int = 15):
    """Device time by kernel over `reps` calls of `fn` (torch.profiler,
    CUPTI), and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    # device-side events only (the CPU ops' entries repeat their kernels' time)
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {
        f"wall_ms_per_{unit}": wall_ms, f"device_busy_ms_per_{unit}": busy,
        f"kernel_launches_per_{unit}": sum(r[2] for r in rows),
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:top]],
    }


def profile_forward(model, config, x, reps: int = 3):
    """Device time by kernel over `reps` bf16 forwards."""
    def forward():
        with torch.inference_mode():
            wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)

    return profile_device(forward, reps, "forward")


def pos_source(cg: int) -> str:
    """The source that instantiates the pos-conv kernels at C/G = `cg`."""
    return CSRC + ("pos_conv_odd8.cu" if cg in POS_ODD8_WIDTHS else "pos_conv.cu")


def pos_conv_eval_check(kernel, bias, shapes, name, gen):
    """The inference pos conv against its plain version at each (rows, T) of
    `shapes`, launched twice (bit-equal).  Returns (max err, mean err, tol,
    the last input)."""
    dev = torch.device("cuda")
    k, cg, h = kernel.shape
    groups = h // cg
    for rows, tt in shapes:
        xs = torch.randn(rows, tt, h, generator=gen).to(dev, torch.bfloat16)
        got = pc.pos_conv(xs, kernel, bias, groups=groups, gelu_approx=True)
        require(torch.equal(got, pc.pos_conv(xs, kernel, bias, groups=groups, gelu_approx=True)),
                f"{name} {rows} x T={tt}: two launches differ")
        want = pc.pos_conv_plain(xs, kernel, bias, groups=groups, gelu_approx=True)
        torch.cuda.synchronize()
        err, mean_err = errors(got, want)
        tol = 0.05
        require(err <= tol and mean_err <= 5e-3, f"{name} {rows} x T={tt}: err {err} / mean {mean_err}")
    return err, mean_err, tol, xs


def pos_conv_eval_record(kernel, bias, b, t, name, paths, gen):
    """The inference pos conv against its plain version at (b, t, C) and at
    T = 3000 (2 rows); returns its record, timed at (b, t, C)."""
    k, cg, h = kernel.shape
    groups = h // cg
    err, mean_err, tol, xs = pos_conv_eval_check(kernel, bias, ((2, 3000), (b, t)), name, gen)
    nbytes = xs.numel() * 2 * 2 + kernel.numel() * 2 + h * 4
    flops = 2 * b * t * k * cg * h
    bms, by = bound(nbytes, flops, PEAK_BF16)
    wt = kernel.to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, CG, K)
    bb = bias.to(torch.bfloat16)

    def library_pos_conv():
        y = torch.nn.functional.conv1d(xs.transpose(1, 2), wt, bb, padding=k // 2, groups=groups)
        return torch.nn.functional.gelu(y[:, :, :t], approximate="tanh")

    return dict(
        name=name, counter="pos_conv", paths=paths, route="cuda", source=pos_source(cg),
        replaces=PALLAS + "pos_conv.py:250", shape=[b, t, h], channels_per_group=cg,
        max_abs_err=err, mean_abs_err=mean_err, tol=tol, relaunch_bit_equal=True,
        ms=time_ms(lambda: pc.pos_conv(xs, kernel, bias, groups=groups, gelu_approx=True), 20),
        plain_ms=time_ms(lambda: pc.pos_conv_plain(xs, kernel, bias, groups=groups, gelu_approx=True), 5),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library_pos_conv, 20),
    )


def _front_library(robust: bool, params, x):
    """One PyTorch call chain of the same function (a yardstick the port
    never calls): conv1d, then group_norm / layer_norm, GELU, conv1d, (layer_norm,)
    GELU, in bf16."""
    fn = torch.nn.functional
    c = params[0].shape[-1]
    w0t = params[0].to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, 1, 10)
    w1t = params[4 if robust else 3].to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, C, 3)
    if robust:
        half = [v.to(torch.bfloat16) for v in params[1:4] + params[5:]]

        def library():
            y = fn.conv1d(x[:, None, :], w0t, half[0], stride=5).transpose(1, 2)
            y = fn.gelu(fn.layer_norm(y, (c,), half[1], half[2], 1e-5), approximate="tanh")
            y = fn.conv1d(y.transpose(1, 2), w1t, half[3], stride=2).transpose(1, 2)
            return fn.gelu(fn.layer_norm(y, (c,), half[4], half[5], 1e-5), approximate="tanh")
        return library
    gb, bb = params[1].to(torch.bfloat16), params[2].to(torch.bfloat16)

    def library():
        y = fn.conv1d(x[:, None, :], w0t, stride=5)
        y = fn.gelu(fn.group_norm(y, c, gb, bb), approximate="tanh")
        return fn.gelu(fn.conv1d(y, w1t, stride=2), approximate="tanh")
    return library


def frontend_checks(x, w0, gamma, beta, w1):
    """groupnorm_stats, then fused_conv01 on its scale and shift, on `x`
    (rows, samples) against their plain versions, each launched twice
    (bit-equal).  Returns the two checks ({max_abs_err, mean_abs_err, tol})
    and the plain (scale, shift)."""
    b, n = x.shape
    c = w0.shape[-1]
    t0, t1 = cf.conv0_length(n), cf.conv1_length(n)
    got = cf.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
    again = cf.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
    require(all(torch.equal(u, v) for u, v in zip(got, again)),
            f"groupnorm_stats {b} x {n}: two launches differ")
    want = cf.groupnorm_stats_plain(x, t0, w0, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    # f32 sums in another order (per-CTA partials, then the cluster in rank
    # order): 1e-5 of each output's scale
    tol = 1e-5 * max(want[0].abs().max().item(), want[1].abs().max().item())
    err, mean_err = max(errors(got[0], want[0]), errors(got[1], want[1]))
    require(err <= tol, f"groupnorm_stats {b} x {n}: max abs err {err} > {tol}")
    gn = dict(max_abs_err=err, mean_abs_err=mean_err, tol=tol)

    scale, shift = want
    got = cf.conv01(x, w0, scale, shift, w1, t1, True)
    require(torch.equal(got, cf.conv01(x, w0, scale, shift, w1, t1, True)),
            f"conv01 {b} x {n}: two launches differ")
    want = cf.conv01_plain(x, w0, scale, shift, w1, t1, True)
    torch.cuda.synchronize()
    require(got.shape == (b, t1, c), f"conv01 shape {tuple(got.shape)}")
    err, mean_err = errors(got, want)
    del got, want
    tol = 0.05  # bf16 output (ulp 2^-6 at |y| in [2, 4)) over f32 sums in another order
    require(err <= tol and mean_err <= 5e-3, f"fused_conv01 {b} x {n}: err {err} / mean {mean_err}")
    return gn, dict(max_abs_err=err, mean_abs_err=mean_err, tol=tol), (scale, shift)


def check_eval_kernels_at(model, records, b, path=None, front="", pos="pos_conv"):
    """groupnorm_stats, fused_conv01 and the inference pos conv against their
    plain versions at b x 246000 (the cli phase runs them there: stage 1's
    forward and the validation batch; base_h192's steps at 8), launched
    twice (bit-equal), at phase 3's tolerances; each check is added to its
    record under `checked_at`, with `path` where one is given.  `front`
    ends the two front-end records' names (`_c384`: the model's front end
    is that instance); `pos` names the pos conv's record (`pos_conv_cg96`:
    base_g8's instance)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    fe = model.wav2vec2.feature_extractor.conv_layers
    x = torch.randn(b, SAMPLES, generator=gen).to(dev, torch.bfloat16)
    gn, c01, _ = frontend_checks(x, fe[0].conv.kernel, fe[0].layer_norm.gamma,
                                 fe[0].layer_norm.beta, fe[1].conv.kernel)
    del x
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    bias = (0.1 * torch.randn(kernel.shape[-1], generator=gen)).to(dev)
    t = model.config.conv_output_length(SAMPLES)
    err, mean_err, tol, _ = pos_conv_eval_check(kernel, bias, ((b, t),), "pos_conv", gen)
    by_name = {r["name"]: r for r in records}
    for name, check in (("groupnorm_stats" + front, gn), ("fused_conv01" + front, c01),
                        (pos, dict(max_abs_err=err, mean_abs_err=mean_err, tol=tol))):
        by_name[name].setdefault("checked_at", []).append(
            {"shape": [b, SAMPLES], **({"path": path} if path else {}), **check,
             "relaunch_bit_equal": True})
    torch.cuda.empty_cache()


def check_kernels(model):
    """Phase 3.  Returns the kernel records (launches filled in later)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    fe = model.wav2vec2.feature_extractor.conv_layers
    w0, w1 = fe[0].conv.kernel, fe[1].conv.kernel
    gamma, beta = fe[0].layer_norm.gamma, fe[0].layer_norm.beta
    c = w0.shape[-1]
    records = []

    # -- groupnorm_stats + fused_conv01 at (16, 246000) -----------------------
    x = torch.randn(B, SAMPLES, generator=gen).to(dev, torch.bfloat16)
    t0, t1 = cf.conv0_length(SAMPLES), cf.conv1_length(SAMPLES)
    gn, c01, (scale, shift) = frontend_checks(x, w0, gamma, beta, w1)
    err, mean_err, tol = gn["max_abs_err"], gn["mean_abs_err"], gn["tol"]
    nbytes = x.numel() * 2 + (10 + 2) * c * 4 + 2 * B * c * 4
    # what the function needs per window: the 55 distinct Gram products (the
    # matrix is symmetric) and 10 sums; then per (row, channel) the folded
    # affine map (a 10-vector dot and a 10x10 quadratic form)
    flops = B * t0 * (2 * 55 + 10) + B * c * (2 * 10 + 2 * 110)
    bms, by = bound(nbytes, flops, PEAK_BF16)
    gram, rsum = cf.window_stats_plain(x, t0)
    records.append(dict(
        name="groupnorm_stats", counter="groupnorm_stats", paths=BASE_PATHS, route="cuda",
        source=CSRC + "conv_frontend.cu", replaces=PALLAS + "conv_frontend.py:87",
        also_replaces=[PALLAS + "conv_frontend.py:239-249 (the XLA tail)"],
        max_abs_err=err, mean_abs_err=mean_err, tol=tol, relaunch_bit_equal=True,
        ms=time_ms(lambda: cf.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5), 50),
        plain_ms=time_ms(lambda: cf.groupnorm_stats_plain(x, t0, w0, gamma, beta, 1e-5), 5),
        # the torch glue the kernel folded in, alone on the card
        glue_ms=time_ms(lambda: cf.groupnorm_scale_shift(gram, rsum, w0, gamma, beta, t0, 1e-5), 50),
        bound_ms=bms, bound_by=by, library_ms=None,
    ))

    err, mean_err, tol = c01["max_abs_err"], c01["mean_abs_err"], c01["tol"]
    nbytes = x.numel() * 2 + (10 * c + 3 * c * c) * 2 + 2 * B * c * 4 + B * t1 * c * 2
    flops = 2 * B * t1 * (2 * 10 * c + 3 * c * c)
    bms, by = bound(nbytes, flops, PEAK_BF16)
    records.append(dict(
        name="fused_conv01", counter="fused_conv01", paths=BASE_PATHS, route="cuda",
        source=CSRC + "conv_frontend.cu", replaces=PALLAS + "conv_frontend.py:251",
        max_abs_err=err, mean_abs_err=mean_err, tol=tol, relaunch_bit_equal=True,
        ms=time_ms(lambda: cf.conv01(x, w0, scale, shift, w1, t1, True), 10),
        plain_ms=time_ms(lambda: cf.conv01_plain(x, w0, scale, shift, w1, t1, True), 3, 1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(_front_library(False, (w0, gamma, beta, w1), x), 10),
    ))
    del x

    # -- pos_conv at (16, 768, 768), also checked at T = 3000 -----------------
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    h = kernel.shape[-1]
    bias = (0.1 * torch.randn(h, generator=gen)).to(dev)
    t = model.config.conv_output_length(SAMPLES)  # 768 frames
    records.append(pos_conv_eval_record(kernel, bias, B, t, "pos_conv",
                                        ("inference", "train", "long_inference", "cli", "serve",
                                         "export", "base_h192", "base_h192_train"), gen))

    # -- flash attention at (16, 12, 768, 64); ragged masks and L = 1249 -------
    heads = model.config.num_heads
    d = h // heads
    checks = []
    for l, ragged in ((1249, True), (t, True), (t, False)):
        q, kk, v = (torch.randn(B, heads, l, d, generator=gen).to(dev, torch.bfloat16)
                    for _ in range(3))
        q = q * (2.0 * d ** -0.5)  # scores with std ~2 after the D^-1/2 prescale
        kb = None
        if ragged:
            lengths = torch.randint(l // 4, l + 1, (B,), generator=gen)
            kb = torch.where(torch.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).to(dev)
        out, lse = fa.flash_attention_fwd(q, kk, v, kb)
        pout, plse = fa.flash_attention_fwd_plain(q, kk, v, kb)
        torch.cuda.synchronize()
        err, mean_err = errors(out, pout)
        lse_err, _ = errors(lse, plse)
        tol = 0.02  # bf16 output; p rounded to bf16 before / after the 1/l scaling
        require(err <= tol and lse_err <= 1e-3, f"flash L={l} ragged={ragged}: {err} / lse {lse_err}")
        checks.append(err)
    nbytes = 4 * q.numel() * 2 + B * heads * t * 4
    flops = 4 * B * heads * t * t * d
    bms, by = bound(nbytes, flops, PEAK_BF16)
    run_flash = lambda: fa.flash_attention_fwd(q, kk, v)
    run_library = lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, v, scale=1.0)
    dev_ms, _ = device_kernels(run_flash)
    lib_dev_ms, lib_kernels = device_kernels(run_library)
    records.append(dict(
        name="flash_attention_fwd", counter="flash_attention_fwd", paths=SHORT_PATHS, route="cuda",
        source=CSRC + "flash_attention.cu", replaces=PALLAS + "flash_attention.py:224",
        shape=[B, heads, t, d], max_abs_err=max(checks), mean_abs_err=mean_err, tol=tol,
        ms=time_ms(run_flash, 50), device_ms=dev_ms,
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(q, kk, v), 5),
        bound_ms=bms, bound_by=by, exp_bound_ms=exp_bound_ms(B * heads * t * t),
        library_ms=time_ms(run_library, 50), library_device_ms=lib_dev_ms, library_kernels=lib_kernels,
    ))
    return records


def pos_conv_train_check(kernel, bias, b, t, suffix, gen):
    """The pos conv's training forward, dx and dW against their plain
    versions at (b, t, C), each launched twice (bit-equal).  Returns
    ({name: (max err, mean err)}, {name: tol}, x, dpre)."""
    dev = torch.device("cuda")
    k, cg, h = kernel.shape
    groups = h // cg
    x, dpre = (torch.randn(b, t, h, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    y, pre = pc.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True)
    py, ppre = pc.pos_conv_train_fwd_plain(x, kernel, bias, groups=groups, gelu_approx=True)
    dx = pc.pos_conv_dx(dpre, kernel, groups=groups)
    pdx = pc.pos_conv_dx_plain(dpre, kernel, groups=groups)
    dw = pc.pos_conv_dw(x, dpre, k, groups=groups)
    pdw = pc.pos_conv_dw_plain(x, dpre, k, groups=groups)
    again = pc.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True)
    require(torch.equal(y, again[0]) and torch.equal(pre, again[1]),
            f"pos_conv_train_fwd{suffix} T={t}: two launches differ")
    require(torch.equal(dx, pc.pos_conv_dx(dpre, kernel, groups=groups)),
            f"pos_conv_dx{suffix} T={t}: two launches differ")
    require(torch.equal(dw, pc.pos_conv_dw(x, dpre, k, groups=groups)),
            f"pos_conv_dw{suffix} T={t}: two launches differ")
    del again
    torch.cuda.synchronize()
    checks = {"pos_conv_train_fwd": errors(y, py), "pre": errors(pre, ppre),
              "pos_conv_dx": errors(dx, pdx), "pos_conv_dw": errors(dw, pdw)}
    # bf16 outputs: as pos_conv (0.05, mean 5e-3); dx 1.5% of its scale
    # (2 ulp at its top); f32 outputs (pre-activation, dW: sums of
    # K*CG (6144 or 8192) and B*T products in another order): 1e-4 of the scale
    scales = {"pre": ppre.abs().max().item(), "pos_conv_dx": pdx.float().abs().max().item(),
              "pos_conv_dw": pdw.abs().max().item()}
    tols = {"pos_conv_train_fwd": 0.05, "pre": 1e-4 * scales["pre"],
            "pos_conv_dx": 0.015 * scales["pos_conv_dx"], "pos_conv_dw": 1e-4 * scales["pos_conv_dw"]}
    for name, (err, mean_err) in checks.items():
        require(err <= tols[name], f"{name} T={t}: err {err} > {tols[name]}")
    require(checks["pos_conv_train_fwd"][1] <= 5e-3, "pos_conv_train_fwd: mean error")
    del y, py, pre, ppre, dx, pdx, dw, pdw
    return checks, tols, x, dpre


def pos_conv_train_records(kernel, bias, b, t, suffix, paths, gen):
    """The pos conv's training forward, dx and dW against their plain
    versions at (b, t, C) and at T = 3000 (2 rows) (`pos_conv_train_check`);
    returns their three records (names + `suffix`), timed at (b, t, C)."""
    k, cg, h = kernel.shape
    groups = h // cg
    for tt in (3000, t):
        checks, tols, x, dpre = pos_conv_train_check(kernel, bias, b if tt == t else 2, tt, suffix, gen)
    flops = 2 * b * t * k * cg * h
    act = x.numel() * 2  # one (B, T, C) bf16 tensor
    wt = kernel.to(torch.bfloat16).permute(2, 1, 0).contiguous()  # (C, CG, K)
    bb16 = bias.to(torch.bfloat16)
    xt, dt = x.transpose(1, 2).contiguous(), dpre.transpose(1, 2).contiguous()
    # the conv's own (B, C, T + 1) output gradient: the cropped frame gets 0
    dy = torch.nn.functional.pad(dt, (0, 1))
    conv_bwd = torch.ops.aten.convolution_backward

    def library_fwd():
        y = torch.nn.functional.conv1d(xt, wt, bb16, padding=k // 2, groups=groups)
        return torch.nn.functional.gelu(y[:, :, :t], approximate="tanh")

    def library_grad(mask):
        return conv_bwd(dy, xt, wt, None, [1], [k // 2], [1], False, [0], groups, mask)

    # dx as one forward grouped conv of dpre with the flipped, swapped kernel:
    # pad (K/2 - 1, K/2) is the symmetric K/2 with the first output dropped
    wdx = pc.dx_kernel(kernel, groups).to(torch.bfloat16).permute(2, 1, 0).contiguous()

    def library_dx():
        return torch.nn.functional.conv1d(dt, wdx, padding=k // 2, groups=groups)[:, :, 1:]

    lib_err = errors(library_dx().transpose(1, 2), pc.pos_conv_dx_plain(dpre, kernel, groups=groups))[0]
    require(lib_err <= tols["pos_conv_dx"], f"the dx yardstick computes another function: {lib_err}")

    specs = [
        ("pos_conv_train_fwd", "gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py:324",
         act + kernel.numel() * 2 + h * 4 + act + 2 * act,  # x, W, b in; y bf16 + pre f32 out
         lambda: pc.pos_conv_train_fwd(x, kernel, bias, groups=groups, gelu_approx=True),
         lambda: pc.pos_conv_train_fwd_plain(x, kernel, bias, groups=groups, gelu_approx=True),
         library_fwd, checks["pos_conv_train_fwd"]),
        ("pos_conv_dx", "gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py:372",
         act + kernel.numel() * 2 + act,  # dpre, W in; dx out
         lambda: pc.pos_conv_dx(dpre, kernel, groups=groups),
         lambda: pc.pos_conv_dx_plain(dpre, kernel, groups=groups),
         library_dx, checks["pos_conv_dx"]),
        ("pos_conv_dw", "gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py:402",
         2 * act + kernel.numel() * 4,  # x, dpre in; dW f32 out
         lambda: pc.pos_conv_dw(x, dpre, k, groups=groups),
         lambda: pc.pos_conv_dw_plain(x, dpre, k, groups=groups),
         lambda: library_grad([False, True, False]), checks["pos_conv_dw"]),
    ]
    records = []
    for name, replaces, nbytes, kern_fn, plain_fn, lib_fn, (err, mean_err) in specs:
        bms, by = bound(nbytes, flops, PEAK_BF16)
        records.append(dict(
            name=name + suffix, counter=name, paths=paths, route="cuda",
            source=pos_source(cg), replaces=replaces, shape=[b, t, h], channels_per_group=cg,
            max_abs_err=err, mean_abs_err=mean_err, tol=tols[name], relaunch_bit_equal=True,
            ms=time_ms(kern_fn, 20), plain_ms=time_ms(plain_fn, 3, 1),
            bound_ms=bms, bound_by=by, library_ms=time_ms(lib_fn, 20),
        ))
    # the input gradient through convolution_backward (what autograd calls on
    # the conv): cuDNN takes another, much slower route; kept for the record
    records[-2]["library_conv_backward_ms"] = time_ms(lambda: library_grad([True, False, False]), 3, 1)
    del x, dpre, xt, dt, dy, wdx
    torch.cuda.empty_cache()
    return records


def _ragged_bias(b: int, l: int, gen: torch.Generator) -> torch.Tensor:
    lengths = torch.randint(l // 4, l + 1, (b,), generator=gen)
    return torch.where(torch.arange(l)[None, :] < lengths[:, None], 0.0, -10000.0).cuda()


def flash_dropout_errors(q, kk, v, dout, kb, rate, seed, what, backward=True, floor=0.0,
                         relaunch=False):
    """The flash forward with dropout `rate` and, on the same inputs, the
    backward, each against its plain version: the forward within 0.04 (0.02
    without dropout), each gradient within 1% of its scale + `floor` (L = 1
    leaves dq = dk = 0 up to rounding); with `relaunch` each launched twice,
    bit-equal.  Returns ((fwd err, mean), out, lse, {dq, dk, dv: err /
    scale}, bwd max abs err, bwd max mean err)."""
    out, lse = fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=seed)
    pout, plse = fa.flash_attention_fwd_plain(q, kk, v, kb, dropout_rate=rate, seed=seed)
    if relaunch:
        again = fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=seed)
        require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                f"flash {what}: two forward launches differ")
    torch.cuda.synchronize()
    err, mean_err = errors(out, pout)
    lse_err, _ = errors(lse, plse)
    # bf16 output (|out| < 4: ulp 2^-6): p rounded to bf16 before / after the
    # 1/l scaling; under dropout also the 1 / (1 - rate) scaling: 2.5 ulp; a
    # mask that differed in one element of a row would move that row by ~|v| p / 0.9
    tol = 0.04 if rate else 0.02
    require(err <= tol and mean_err <= 2e-3 and lse_err <= 1e-3,
            f"flash dropout {what}: {err} / mean {mean_err} / lse {lse_err}")
    rel, bwd_abs, bwd_mean = {}, 0.0, 0.0
    if backward:
        grads = fa.flash_attention_bwd(q, kk, v, kb, pout, plse, dout, dropout_rate=rate, seed=seed)
        if relaunch:
            again = fa.flash_attention_bwd(q, kk, v, kb, pout, plse, dout, dropout_rate=rate, seed=seed)
            require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                    f"flash bwd {what}: two launches differ")
        pgrads = fa.flash_attention_bwd_plain(q, kk, v, kb, pout, plse, dout,
                                              dropout_rate=rate, seed=seed)
        torch.cuda.synchronize()
        for name, g, pg in zip(("dq", "dk", "dv"), grads, pgrads):
            gerr, gmean = errors(g, pg)
            scale = pg.float().abs().max().item()
            # bf16 outputs of f32 sums over L in another order: 1% of the
            # tensor's scale (~1.3 ulp at its top), mean 0.1%
            require(gerr <= 0.01 * scale + floor and gmean <= 1e-3 * scale + floor,
                    f"flash bwd {name} {what}: {gerr} / mean {gmean} (scale {scale})")
            rel[name] = gerr / scale if scale else 0.0
            bwd_abs, bwd_mean = max(bwd_abs, gerr), max(bwd_mean, gmean)
    return (err, mean_err), out, lse, rel, bwd_abs, bwd_mean


def flash_peak(dtype) -> float:
    """The peak a flash product runs at: bf16 tensor cores, or in f32 three
    TF32 products a product (`csrc/flash_attention_f32.cu`)."""
    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32 / 3


def flash_train_records(q, kk, v, dout, kb, out, lse, rate, seed):
    """Times and bounds of the flash forward (with dropout `rate`) and of the
    backward at q's shape, with the key bias `kb` or none: (forward dict,
    backward dict), each with ms (CUDA events), device_ms (profiler),
    plain_ms, bound_ms, bound_by, exp_bound_ms and library_ms (SDPA with the
    same mask and rate), with the names of the kernels SDPA launched."""
    b, heads, l, d = q.shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_qkv, esize, peak = q.numel(), q.element_size(), flash_peak(q.dtype)
    mask4 = None if kb is None else kb[:, None, None, :].to(q.dtype)  # SDPA's additive mask
    shape = dict(shape=[b, heads, l, d], dropout=rate, ragged_bias=kb is not None)
    bias_bytes = 0 if kb is None else b * l * 4
    nbytes = 4 * n_qkv * esize + b * heads * l * 4 + bias_bytes
    bms, by = bound(nbytes, 4 * b * heads * l * l * d, peak)
    run_flash = lambda: fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=seed)
    run_library = lambda: sdpa(q, kk, v, attn_mask=mask4, dropout_p=rate, scale=1.0)
    dev_ms, _ = device_kernels(run_flash)
    lib_dev_ms, lib_kernels = device_kernels(run_library)
    fwd = dict(
        **shape, ms=time_ms(run_flash, 30), device_ms=dev_ms,
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
            q, kk, v, kb, dropout_rate=rate, seed=seed), 3, 1),
        bound_ms=bms, bound_by=by, exp_bound_ms=exp_bound_ms(b * heads * l * l),
        library_ms=time_ms(run_library, 30), library_device_ms=lib_dev_ms, library_kernels=lib_kernels,
    )
    # backward: q, k, v, out, dout, lse, bias in; dq, dk, dv out; the five
    # products S, dP, dV, dK, dQ of 2 B H L^2 D each; the exponentials of p
    # in both passes (dK/dV and dQ recompute them)
    nbytes = 8 * n_qkv * esize + b * heads * l * 4 + bias_bytes
    bms, by = bound(nbytes, 5 * 2 * b * heads * l * l * d, peak)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, kk, v))
    lib_out = sdpa(qg, kg, vg, attn_mask=mask4, dropout_p=rate, scale=1.0)
    run_flash = lambda: fa.flash_attention_bwd(q, kk, v, kb, out, lse, dout, dropout_rate=rate, seed=seed)
    run_library = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True)
    dev_ms, _ = device_kernels(run_flash)
    lib_dev_ms, lib_kernels = device_kernels(run_library)
    bwd = dict(
        **shape, ms=time_ms(run_flash, 30), device_ms=dev_ms,
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
            q, kk, v, kb, out, lse, dout, dropout_rate=rate, seed=seed), 3, 1),
        bound_ms=bms, bound_by=by, exp_bound_ms=exp_bound_ms(2 * b * heads * l * l),
        library_ms=time_ms(run_library, 30), library_device_ms=lib_dev_ms, library_kernels=lib_kernels,
    )
    return fwd, bwd


def _peaky(b, heads, l, d, gen, n=4, dtype=torch.bfloat16, std=2.0):
    """q, k, v (and dout) in `dtype` with scores of std ~`std` after the D^-1/2 prescale."""
    ts = [torch.randn(b, heads, l, d, generator=gen).cuda().to(dtype) for _ in range(n)]
    ts[0] = ts[0] * (std * d ** -0.5)
    return ts


def check_train_kernels(model, records):
    """Phase 3, training shapes (B=32 x 246000: L = T = 768, base width):
    flash forward with dropout (into the forward's record), flash backward,
    and the positional conv's training forward, dx and dW.  Appends records."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    heads = model.config.num_heads
    h = model.config.hidden_size
    d = h // heads
    t = model.config.conv_output_length(SAMPLES)  # 768
    rate, seed = 0.1, 12345

    # -- flash forward with dropout 0.1; ragged bias; L = 768 and 1249 --------
    fwd = next(r for r in records if r["name"] == "flash_attention_fwd")
    bwd_errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    fwd_err, bwd_abs, bwd_mean = (0.0, 0.0), 0.0, 0.0
    for b, l in ((8, 1249), (TRAIN_B, t)):
        q, kk, v, dout = _peaky(b, heads, l, d, gen)
        kb = _ragged_bias(b, l, gen)
        err, out, lse, rel, gabs, gmean = flash_dropout_errors(q, kk, v, dout, kb, rate, seed, f"L={l}")
        fwd_err = max(fwd_err, err)
        bwd_errs = {n: max(bwd_errs[n], rel[n]) for n in rel}
        bwd_abs, bwd_mean = max(bwd_abs, gabs), max(bwd_mean, gmean)
    fwd_rec, bwd_rec = flash_train_records(q, kk, v, dout, kb, out, lse, rate, seed)
    fwd["train"] = dict(max_abs_err=fwd_err[0], mean_abs_err=fwd_err[1], tol=0.04, **fwd_rec)
    records.append(dict(
        name="flash_attention_bwd", counter="flash_attention_bwd",
        paths=("robust_train",) + TRAIN_PATHS,
        route="cuda", source=CSRC + "flash_attention.cu", replaces=PALLAS + "flash_attention.py:285",
        max_abs_err=bwd_abs, mean_abs_err=bwd_mean, max_rel_err_by_grad=bwd_errs,
        tol="0.01 x each gradient's max |value|", **bwd_rec,
    ))
    del q, kk, v, dout, out, lse
    torch.cuda.empty_cache()

    # -- positional conv: training forward, dx (also at T = 3000), dW --------
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    bias = (0.1 * torch.randn(h, generator=gen)).to(dev)
    records.extend(pos_conv_train_records(
        kernel, bias, TRAIN_B, t, "", ("long_train",) + TRAIN_PATHS, gen))


def check_robust_kernels(model, records):
    """Phase 7, first part: the robust/large shapes (B=8 x 246000; C = 512 conv stack
    with LayerNorm and bias, 1024-d, 16 heads, pos conv at 64 channels a
    group): `conv01_robust` and the four pos-conv kernels get records; the
    flash forward is checked at H = 16 with a ragged bias (into its record)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5678)
    fe = model.wav2vec2.feature_extractor.conv_layers
    # random biases and affines: the model's own are zeros and ones
    c = fe[0].conv.kernel.shape[-1]
    vec = lambda scale, offset: (offset + scale * torch.randn(c, generator=gen)).to(dev)
    params = (fe[0].conv.kernel, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0),
              fe[1].conv.kernel, vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0))
    b = ROBUST_B
    x = torch.randn(b, SAMPLES, generator=gen).to(dev, torch.bfloat16)
    t1 = cf.conv1_length(SAMPLES)  # 24599: the last tile is ragged
    got = cf.conv01_robust(x, *params, t1, 1e-5, True)
    require(torch.equal(got, cf.conv01_robust(x, *params, t1, 1e-5, True)),
            "conv01_robust: two launches differ")
    want = cf.conv01_robust_plain(x, *params, t1, 1e-5, True)
    torch.cuda.synchronize()
    require(got.shape == (b, t1, c), f"conv01_robust shape {tuple(got.shape)}")
    err, mean_err = errors(got, want)
    del want, got
    tol = 0.05  # bf16 output (ulp 2^-6 at |y| in [2, 4)) over f32 sums in another order
    require(err <= tol and mean_err <= 5e-3, f"conv01_robust: err {err} / mean {mean_err}")
    nbytes = x.numel() * 2 + (10 * c + 3 * c * c) * 2 + 6 * c * 4 + b * t1 * c * 2
    flops = 2 * b * t1 * (2 * 10 * c + 3 * c * c)
    bms, by = bound(nbytes, flops, PEAK_BF16)
    records.append(dict(
        name="conv01_robust", counter="conv01_robust",
        paths=ROBUST_PATHS + XLARGE_PATHS + H128_PATHS + H256_PATHS, route="cuda",
        source=CSRC + "conv_frontend.cu", replaces=PALLAS + "conv_frontend.py:334",
        shape=[b, SAMPLES], max_abs_err=err, mean_abs_err=mean_err, tol=tol,
        relaunch_bit_equal=True,
        ms=time_ms(lambda: cf.conv01_robust(x, *params, t1, 1e-5, True), 10),
        plain_ms=time_ms(lambda: cf.conv01_robust_plain(x, *params, t1, 1e-5, True), 3, 1),
        bound_ms=bms, bound_by=by, library_ms=time_ms(_front_library(True, params, x), 10),
    ))
    del x
    torch.cuda.empty_cache()

    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    h = kernel.shape[-1]
    require(kernel.shape[1] == 64, f"robust pos conv C/G {kernel.shape[1]}")
    bias = (0.1 * torch.randn(h, generator=gen)).to(dev)
    t = model.config.conv_output_length(SAMPLES)  # 768
    records.append(pos_conv_eval_record(kernel, bias, b, t, "pos_conv_cg64",
                                        ROBUST_PATHS + ("robust_h128", "robust_h256"), gen))
    records.extend(pos_conv_train_records(kernel, bias, b, t, "_cg64",
                                          ("robust_train", "robust_h128_train", "robust_h256_train"),
                                          gen))

    # flash forward at (8, 16, 768, 64), ragged bias, with and without dropout
    heads = model.config.num_heads
    q, kk, v, dout = _peaky(b, heads, t, h // heads, gen)
    kb = _ragged_bias(b, t, gen)
    out, _ = fa.flash_attention_fwd(q, kk, v, kb)
    pout, _ = fa.flash_attention_fwd_plain(q, kk, v, kb)
    torch.cuda.synchronize()
    err, mean_err = errors(out, pout)
    require(err <= 0.02, f"flash H={heads} ragged: {err}")
    derr, _, _, rel, _, _ = flash_dropout_errors(q, kk, v, dout, kb, 0.1, 321, f"H={heads}")
    fwd = next(r for r in records if r["name"] == "flash_attention_fwd")
    bwd = next(r for r in records if r["name"] == "flash_attention_bwd")
    run_flash = lambda: fa.flash_attention_fwd(q, kk, v, kb)
    run_library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, v, attn_mask=kb[:, None, None, :].to(q.dtype), scale=1.0)
    dev_ms, _ = device_kernels(run_flash)
    lib_dev_ms, lib_kernels = device_kernels(run_library)
    d = h // heads
    bms, by = bound(4 * q.numel() * 2 + b * heads * t * 4 + b * t * 4, 4 * b * heads * t * t * d, PEAK_BF16)
    fwd["robust"] = dict(
        shape=[b, heads, t, d], ragged_bias=True, max_abs_err=err, mean_abs_err=mean_err,
        tol=0.02, dropout_max_abs_err=derr[0], bwd_max_rel_err_by_grad=rel,
        ms=time_ms(run_flash, 30), device_ms=dev_ms, bound_ms=bms, bound_by=by,
        exp_bound_ms=exp_bound_ms(b * heads * t * t), library_ms=time_ms(run_library, 30),
        library_device_ms=lib_dev_ms, library_kernels=lib_kernels)
    # the robust training pair: forward with dropout 0.1 and the backward
    out, lse = fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=0.1, seed=321)
    fwd_rec, bwd_rec = flash_train_records(q, kk, v, dout, kb, out, lse, 0.1, 321)
    fwd["robust"]["train"] = fwd_rec
    bwd["robust"] = dict(max_rel_err_by_grad=rel, **bwd_rec)
    torch.cuda.empty_cache()


def check_long_kernels(model, records):
    """Phase 3, the long shapes (base width; 1 x 1,920,000 samples = 5999
    frames).  The flash forward and backward past 4096 frames, where the JAX
    package switches to its kv-blocked kernels, get records of their own
    (the same CUDA kernels as at L <= 4096): checked at L = 5999 (hash stride
    6016) and 8192 with dropout 0.1 and a ragged bias, forward also at 32768;
    timed at the path's (1, 12, 5999, 64).  The conv front end at 1,920,000
    samples and the pos-conv kernels at T = 5999 are held against their
    plain versions (into their records)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2468)
    config = model.config
    heads, h = config.num_heads, config.hidden_size
    d = h // heads
    rate, seed = 0.1, 2**23 - 5
    by_name = {r["name"]: r for r in records}

    # -- flash: L = 32768 forward (B*H = 1: the plain version holds L x L) -----
    l = 32768
    q, kk, v = _peaky(1, 1, l, d, gen, n=3)
    kb = _ragged_bias(1, l, gen)
    err32k, _, _, _, _, _ = flash_dropout_errors(q, kk, v, None, kb, rate, seed, f"L={l}",
                                                 backward=False)
    del q, kk, v
    torch.cuda.empty_cache()
    # -- L = 8192 (B*H = 4) and the path's L = 5999 (H = 12), forward and backward
    fwd_err, bwd_errs, bwd_abs, bwd_mean = (0.0, 0.0), {"dq": 0.0, "dk": 0.0, "dv": 0.0}, 0.0, 0.0
    for hh, l in ((4, 8192), (heads, config.conv_output_length(LONG_SAMPLES))):
        q, kk, v, dout = _peaky(1, hh, l, d, gen)
        kb = _ragged_bias(1, l, gen)
        err, out, lse, rel, gabs, gmean = flash_dropout_errors(q, kk, v, dout, kb, rate, seed, f"L={l}")
        torch.cuda.empty_cache()
        fwd_err = max(fwd_err, err)
        bwd_errs = {n: max(bwd_errs[n], rel[n]) for n in rel}
        bwd_abs, bwd_mean = max(bwd_abs, gabs), max(bwd_mean, gmean)
    require(l == 5999, f"the long path has {l} frames")
    fwd_rec, bwd_rec = flash_train_records(q, kk, v, dout, kb, out, lse, rate, seed)
    checked = [5999, 8192]
    records.append(dict(
        name="flash_attention_fwd_long", counter="flash_attention_fwd", paths=LONG_PATHS,
        route="cuda", source=CSRC + "flash_attention.cu", replaces=PALLAS + "flash_attention.py:516",
        same_kernel_as="flash_attention_fwd", checked_at_L=checked + [32768],
        max_abs_err=max(fwd_err[0], err32k[0]), mean_abs_err=max(fwd_err[1], err32k[1]), tol=0.04,
        max_abs_err_L32768=err32k[0], **fwd_rec,
    ))
    records.append(dict(
        name="flash_attention_bwd_long", counter="flash_attention_bwd", paths=("long_train",),
        route="cuda", source=CSRC + "flash_attention.cu", replaces=PALLAS + "flash_attention.py:595",
        also_replaces=[PALLAS + "flash_attention.py:638"], same_kernel_as="flash_attention_bwd",
        checked_at_L=checked, max_abs_err=bwd_abs, mean_abs_err=bwd_mean,
        max_rel_err_by_grad=bwd_errs, tol="0.01 x each gradient's max |value|", **bwd_rec,
    ))
    del q, kk, v, dout, out, lse
    torch.cuda.empty_cache()

    # -- the base conv front end at (1, 1,920,000) -------------------------------
    fe = model.wav2vec2.feature_extractor.conv_layers
    w0, w1 = fe[0].conv.kernel, fe[1].conv.kernel
    x = torch.randn(1, LONG_SAMPLES, generator=gen).to(dev, torch.bfloat16)
    t0, t1 = cf.conv0_length(LONG_SAMPLES), cf.conv1_length(LONG_SAMPLES)
    gamma, beta = fe[0].layer_norm.gamma, fe[0].layer_norm.beta
    got = cf.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
    scale, shift = cf.groupnorm_stats_plain(x, t0, w0, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    tol = 1e-5 * max(scale.abs().max().item(), shift.abs().max().item())
    err, _ = max(errors(got[0], scale), errors(got[1], shift))
    require(err <= tol, f"groupnorm_stats at {LONG_SAMPLES} samples: {err} > {tol}")
    by_name["groupnorm_stats"]["long"] = dict(
        shape=[1, LONG_SAMPLES], max_abs_err=err, tol=tol,
        ms=time_ms(lambda: cf.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5), 20))
    err, mean_err = errors(cf.conv01(x, w0, scale, shift, w1, t1, True),
                           cf.conv01_plain(x, w0, scale, shift, w1, t1, True))
    require(err <= 0.05 and mean_err <= 5e-3, f"fused_conv01 at {LONG_SAMPLES} samples: {err}")
    by_name["fused_conv01"]["long"] = dict(
        shape=[1, LONG_SAMPLES], max_abs_err=err, mean_abs_err=mean_err, tol=0.05,
        ms=time_ms(lambda: cf.conv01(x, w0, scale, shift, w1, t1, True), 5))
    del x
    torch.cuda.empty_cache()

    # -- the pos-conv kernels at (1, 5999, 768) ----------------------------------
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    k, cg, _ = kernel.shape
    groups = h // cg
    bias = (0.1 * torch.randn(h, generator=gen)).to(dev)
    xs, dpre = (torch.randn(1, l, h, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    y, pre = pc.pos_conv_train_fwd(xs, kernel, bias, groups=groups, gelu_approx=True)
    py, ppre = pc.pos_conv_train_fwd_plain(xs, kernel, bias, groups=groups, gelu_approx=True)
    pdx = pc.pos_conv_dx_plain(dpre, kernel, groups=groups)
    pdw = pc.pos_conv_dw_plain(xs, dpre, k, groups=groups)
    held = {
        "pos_conv": (pc.pos_conv(xs, kernel, bias, groups=groups, gelu_approx=True), py, 0.05),
        "pos_conv_train_fwd": (y, py, 0.05),
        "pre": (pre, ppre, 1e-4 * ppre.abs().max().item()),
        "pos_conv_dx": (pc.pos_conv_dx(dpre, kernel, groups=groups), pdx,
                        0.015 * pdx.float().abs().max().item()),
        "pos_conv_dw": (pc.pos_conv_dw(xs, dpre, k, groups=groups), pdw,
                        1e-4 * pdw.abs().max().item()),
    }
    torch.cuda.synchronize()
    for name, (got, want, tol) in held.items():
        err, mean_err = errors(got, want)
        require(err <= tol, f"{name} at T={l}: err {err} > {tol}")
        if name in by_name:
            by_name[name]["long"] = dict(shape=[1, l, h], max_abs_err=err, mean_abs_err=mean_err, tol=tol)
    by_name["pos_conv_train_fwd"]["long"]["pre_max_abs_err"] = errors(pre, ppre)[0]
    torch.cuda.empty_cache()


CTC_T = 768          # frames of 246000 samples
CTC_LONG_T = 5999    # frames of the long cell's 1,920,000 samples
CTC_WIDE_V = 8192    # a subword vocabulary's classes


def _ctc_case(gen, b: int, t: int, vocab: int, short_rows: int, infeasible: bool):
    """f32 log-probs (B, T, V), labels of 50-200 ids (pad 0), logit lengths:
    the last `short_rows` rows cut to 400-T frames; with `infeasible`, the
    last row's 200 labels all equal (they need 399 frames) in 300 frames."""
    dev = torch.device("cuda")
    log_probs = torch.log_softmax(2.0 * torch.randn(b, t, vocab, generator=gen), -1)
    labels = torch.zeros(b, 200, dtype=torch.int64)
    lengths = torch.full((b,), t, dtype=torch.int64)
    for i in range(b):
        n = int(torch.randint(50, 201, (), generator=gen))
        labels[i, :n] = torch.randint(1, vocab, (n,), generator=gen)
        if i >= b - short_rows:
            lengths[i] = int(torch.randint(400, t + 1, (), generator=gen))
    if infeasible:
        labels[-1], lengths[-1] = 1, 300
    return log_probs.to(dev), labels.to(dev), lengths.to(dev)


def _ctc_loss_and_grad(fn, log_probs, labels, lengths):
    x = log_probs.clone().requires_grad_(True)
    loss = fn(x, labels, lengths)
    loss.sum().backward()
    torch.cuda.synchronize()
    return loss.detach(), x.grad


def ctc_errors(log_probs, labels, lengths, infeasible: bool, what: str) -> dict:
    """The kernels (through `ctc_loss`) against `ctc_loss_plain` on the same
    inputs: loss rtol 1e-5, gradient atol 1e-5; two launches bit-equal; an
    infeasible row finite (loss >= 1e4)."""
    loss, grad = _ctc_loss_and_grad(ctck.ctc_loss, log_probs, labels, lengths)
    loss2, grad2 = _ctc_loss_and_grad(ctck.ctc_loss, log_probs, labels, lengths)
    require(torch.equal(loss, loss2) and torch.equal(grad, grad2),
            f"ctc {what}: two launches on the same inputs differ")
    ploss, pgrad = _ctc_loss_and_grad(ctck.ctc_loss_plain, log_probs, labels, lengths)
    loss_rel = ((loss - ploss).abs() / ploss.abs()).max().item()
    grad_err = (grad - pgrad).abs().max().item()
    require(bool(torch.isfinite(loss).all() and torch.isfinite(grad).all()),
            f"ctc {what}: non-finite loss or gradient")
    require(loss_rel <= 1e-5 and grad_err <= 1e-5,
            f"ctc {what}: kernels vs plain loss rel {loss_rel}, gradient {grad_err}")
    if infeasible:
        require(loss[-1].item() >= 1e4, f"ctc {what}: the infeasible row's loss {loss[-1].item()}")
    past = torch.arange(grad.shape[1], device=grad.device)[None, :] >= lengths[:, None]
    require(not grad[past].any(), f"ctc {what}: a gradient past a row's logit length")
    return {"loss_max_rel_err": loss_rel, "grad_max_abs_err": grad_err,
            "grad_mean_abs_err": (grad - pgrad).abs().mean().item(),
            "infeasible_row_loss": loss[-1].item() if infeasible else None,
            "relaunch_bit_equal": True}


def ctc_work(log_probs, labels, lengths):
    """The states the recursion touches (sum over rows of frames x (2L+1))
    and the bytes each kernel must move, from this run's data."""
    b, t, v = log_probs.shape
    lab = (labels != 0).sum(1)
    states = int((lengths.clamp(max=t) * (2 * lab + 1)).sum())
    lp_bytes, lab_bytes = log_probs.numel() * 4, labels.numel() * 4 + b * 4
    return states, (lp_bytes + lab_bytes + b * 4 + states * 4,    # forward: + loss, states
                    lp_bytes + lab_bytes + states * 4 + b * 4 + lp_bytes)  # backward: + gradient


def _ctc_wide_case(gen, n: int, t: int = 200):
    """Two rows at label width n (V = 32): row 0 n/2-n random ids, row 1 n
    equal ids (they need 2n - 1 frames: infeasible in t = 200)."""
    dev = torch.device("cuda")
    log_probs = torch.log_softmax(2.0 * torch.randn(2, t, 32, generator=gen), -1)
    labels = torch.zeros(2, n, dtype=torch.int64)
    m = int(torch.randint(n // 2, n + 1, (), generator=gen))
    labels[0, :m] = torch.randint(1, 32, (m,), generator=gen)
    labels[1] = 1
    lengths = torch.tensor([t, int(torch.randint(t // 2, t + 1, (), generator=gen))])
    return log_probs.to(dev), labels.to(dev), lengths.to(dev)


# label widths at the end of each kernel instance: the forward's slots a
# lane (1 up to 512 positions, 2, 4, then 8 for 2049) and the backward's
# compile-time single chain warp (256 positions)
CTC_EDGE_WIDTHS = (255, 511, 1023, 2047, 2048)


def _ctc_times(log_probs, labels, lengths):
    """Device ms a call of the CTC wrappers and of `F.ctc_loss` (forward,
    and its backward alone) on the same inputs, by CUDA events, and each
    wrapper's kernels by the profiler."""
    b = log_probs.shape[0]
    ones = torch.ones(b, device=log_probs.device)
    _, states = ctck.ctc_loss_fwd(log_probs, labels, lengths)
    xl = log_probs.clone().requires_grad_(True)
    library = lambda: torch.nn.functional.ctc_loss(  # noqa: E731
        xl.transpose(0, 1), labels, lengths, (labels != 0).sum(1), reduction="none",
        zero_infinity=True)
    lib_loss = library().sum()
    fwd = lambda: ctck.ctc_loss_fwd(log_probs, labels, lengths)  # noqa: E731
    bwd = lambda: ctck.ctc_loss_bwd(log_probs, labels, lengths, states, ones)  # noqa: E731
    iters = 20 if log_probs.shape[1] < 2000 else 3
    out = {"fwd": time_ms(fwd, iters), "bwd": time_ms(bwd, iters),
           "library_fwd": time_ms(library, iters),
           "library_bwd": time_ms(lambda: torch.autograd.grad(lib_loss, xl, retain_graph=True),
                                  iters)}
    for which, fn in (("fwd", fwd), ("bwd", bwd)):
        prof = profile_device(fn, 5, "call", top=8)
        out[f"{which}_device_ms"] = prof["device_busy_ms_per_call"]
        out[f"{which}_kernels_ms"] = {k["kernel"][:60]: k["ms"] for k in prof["top"]}
    return out


def check_ctc_kernels(records):
    """Phase 3: the CTC kernels at the recipe's 32 x 768 frames (V = 32,
    labels 50-200, 8 rows short, one infeasible), a data-2 rank's 16 x 768,
    1 x 5999 frames, a subword vocabulary (4 x 400 frames, V = 8192) and the
    widest label row of each kernel instance (`CTC_EDGE_WIDTHS`), against
    `ctc_loss_plain`; more than `MAX_LABELS` label positions must raise;
    the kernels' log1p against the math library's over every float in
    [0, 1]; times beside `F.ctc_loss` (forward, and its backward alone),
    the profiler's device ms, and the chain bound (the longest row's frames
    times one frame's critical path, timed on the card)."""
    gen = torch.Generator().manual_seed(77)
    mismatches = ctck.log1p_mismatches()
    require(mismatches == 0, f"ctc: the kernels' log1p differs from log1pf on {mismatches} floats")
    log_probs, labels, lengths = _ctc_case(gen, TRAIN_B, CTC_T, 32, 8, True)
    check = ctc_errors(log_probs, labels, lengths, True, f"{TRAIN_B} x {CTC_T}")
    rank_case = _ctc_case(gen, TRAIN_B // 2, CTC_T, 32, 4, True)
    rank_check = ctc_errors(*rank_case, True, f"{TRAIN_B // 2} x {CTC_T}")
    long_lp, long_labels, long_lengths = _ctc_case(gen, 1, CTC_LONG_T, 32, 0, False)
    long_check = ctc_errors(long_lp, long_labels, long_lengths, False, f"1 x {CTC_LONG_T}")
    vocab_case = _ctc_case(gen, 4, 400, CTC_WIDE_V, 2, False)
    vocab_check = ctc_errors(*vocab_case, False, f"V = {CTC_WIDE_V}")
    edges = []
    for n in CTC_EDGE_WIDTHS:
        p = ctck.plan(n, 32)
        edges.append({"labels": n, "fwd_lane_slots": p.fwd_lane_slots, "fwd_warps": p.fwd_warps,
                      "bwd_warps": p.bwd_warps,
                      **ctc_errors(*_ctc_wide_case(gen, n), True, f"label width {n}")})
    wide = torch.zeros(1, ctck.MAX_LABELS + 1, dtype=torch.int64, device=log_probs.device)
    try:
        ctc_loss_fn(log_probs[:1], wide, lengths[:1], 0)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"ctc: {ctck.MAX_LABELS + 1} label positions did not raise on the card")

    ones = torch.ones(TRAIN_B, device=log_probs.device)
    _, states = ctck.ctc_loss_fwd(log_probs, labels, lengths)
    x = log_probs.clone().requires_grad_(True)
    plain_loss = ctck.ctc_loss_plain(x, labels, lengths).sum()
    n_states, (fwd_bytes, bwd_bytes) = ctc_work(log_probs, labels, lengths)
    # a log-add-exp is ~7 f32 operations and 2 SFU results (exp, log1p): the
    # forward does 3 a state and frame, the backward recomputes them and takes
    # 6 more exponentials and ~12 products and sums
    fwd_ops, bwd_ops = 21 * n_states, 39 * n_states
    chain = int(lengths.max())
    step_ms = {"fwd": ctck.chain_step_ms(False), "bwd": ctck.chain_step_ms(True)}
    times = _ctc_times(log_probs, labels, lengths)
    times["plain_fwd"] = time_ms(lambda: ctck.ctc_loss_plain(log_probs, labels, lengths), 2, 1)
    times["plain_bwd"] = time_ms(lambda: torch.autograd.grad(plain_loss, x, retain_graph=True), 2, 1)
    rank_times = _ctc_times(*rank_case)
    require(rank_times["fwd"] <= rank_times["library_fwd"] * 1.05,
            f"ctc {TRAIN_B // 2} x {CTC_T}: the forward {rank_times['fwd']} ms against F.ctc_loss's "
            f"{rank_times['library_fwd']}")
    long_times = _ctc_times(long_lp, long_labels, long_lengths)
    p = ctck.plan(labels.shape[1], 32)
    shape = [TRAIN_B, CTC_T, 32, labels.shape[1]]
    common = dict(route="cuda", source=CSRC + "ctc.cu", paths=CTC_PATHS,
                  replaces="gsoc_wav2vec2_tpu/ops/ctc.py:52 (optax.ctc_loss, no Pallas kernel)",
                  shape=shape, states_touched=n_states, chain_frames=chain, **check,
                  max_abs_err=check["grad_max_abs_err"], tol={"loss_rtol": 1e-5, "grad_atol": 1e-5},
                  plan={"fwd_lane_slots": p.fwd_lane_slots, "fwd_warps": p.fwd_warps,
                        "bulk": p.bulk, "bwd_warps": p.bwd_warps, "coef_groups": p.coef_groups},
                  chain_step_ms=step_ms, log1p_mismatches=mismatches,
                  rank={"shape": [TRAIN_B // 2, CTC_T, 32, 200], **rank_check, **rank_times},
                  long={"shape": [1, CTC_LONG_T, 32, long_labels.shape[1]], **long_check,
                        **long_times,
                        "chain_bound_ms": {k: CTC_LONG_T * v for k, v in step_ms.items()}},
                  wide_vocab={"shape": [4, 400, CTC_WIDE_V, 200], **vocab_check},
                  instance_edges=edges, wide_labels_refused=refused,
                  library="F.ctc_loss (zero_infinity), forward and its backward alone")
    del vocab_case, rank_case
    for which, nbytes, ops, n_exp in (("fwd", fwd_bytes, fwd_ops, 6 * n_states),
                                      ("bwd", bwd_bytes, bwd_ops, 12 * n_states)):
        bms, by = bound(nbytes, ops, PEAK_F32)
        chain_ms = chain * step_ms[which]
        records.append(dict(
            name=f"ctc_loss_{which}", counter=f"ctc_loss_{which}", ms=times[which],
            plain_ms=times[f"plain_{which}"], library_ms=times[f"library_{which}"],
            bound_ms=bms, bound_by=by, exp_bound_ms=exp_bound_ms(n_exp),
            device_ms=times[f"{which}_device_ms"], kernels_ms=times[f"{which}_kernels_ms"],
            chain_bound_ms=chain_ms, chain_share=chain_ms / times[which],
            ms_per_frame=times[which] / chain, **common))
    records[-1]["fwd_bwd_ms"] = times["fwd"] + times["bwd"]
    records[-1]["library_fwd_bwd_ms"] = times["library_fwd"] + times["library_bwd"]
    del states, x, plain_loss
    torch.cuda.empty_cache()


def _labels(rng, b: int, vocab: int, longest: int = 200) -> np.ndarray:
    """50-`longest` non-pad ids per sample from the vocabulary, pad (0) after."""
    lengths = rng.integers(50, longest + 1, size=b)
    labels = np.zeros((b, longest), np.int64)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, vocab, size=n)
    return labels


def train_phase(phase, what, model, config, batch, per_step, steps, smi, **step_kwargs):
    """One stage-1 step and `steps` stage-2 steps of `make_train_step` on
    `model`, launch counts held exactly per stage-2 step.  Returns the launch
    counts of the counted run and the stage-2 step function and state."""
    b = batch["speech"].shape[0]
    gen = torch.Generator().manual_seed(0)
    reset_counts()
    # stage 1: the backbone frozen, Adam 1e-3 on the head
    set_trainable(model, STAGE1)
    st = create_train_state(model, create_optimizer(model, 1e-3))
    step1 = make_train_step(config, division_factor=b, **step_kwargs)
    st, m1 = step1(st, batch, gen)
    loss1 = m1["loss"].item()
    # stage 2: all but the conv front end, Adam 1e-4
    mask = set_trainable(model, STAGE2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    st = create_train_state(model, create_optimizer(model, 1e-4))
    step2 = make_train_step(config, division_factor=b, **step_kwargs)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    for i in range(steps):
        counts = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step2(st, batch, gen)
        losses.append(m["loss"].item())  # reads back: the step is done
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        norms.append(m["grad_norm"].item())
        expect_counts(f"{phase} stage-2 step {i}", counts_since(counts), per_step)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(all(np.isfinite(losses + norms)) and np.isfinite(loss1), f"losses {loss1} {losses}")
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        require(same != mask[name], f"{name}: trainable {mask[name]}, unchanged {same}")
    steady = times[2:]
    step_ms = statistics.median(steady)
    audio_s = b * batch["speech"].shape[1] / 16000
    emit({"phase": phase, "config": what, "batch": list(batch["speech"].shape),
          "stage1_loss": loss1, "stage2_losses": losses,
          "stage2_grad_norms": norms, "launches_per_stage2_step": per_step,
          "ms_per_stage2_step": step_ms, "ms_min_max": [min(steady), max(steady)],
          "steps_timed": len(steady), "first_steps_ms": times[:2],
          "audio_s_trained_per_s": audio_s / (step_ms / 1e3), "peak_memory_gb": peak_gb,
          "card": smi})
    # one more stage-2 step under the profiler (after the counted run)
    emit({"phase": phase + "_profile", "card": smi,
          **profile_device(lambda: step2(st, batch, gen), 1, "stage2_step", top=25)})
    return launches


def base_train_phase(smi: str):
    """Phase 6.  Returns the launch counts of the counted run."""
    config = Wav2Vec2Config()  # base, the recipe's dropout 0.1 and SpecAugment
    require(config.dropout == 0.1 and config.apply_spec_augment, "the recipe's regularisation")
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"speech": rng.standard_normal((TRAIN_B, SAMPLES)).astype(np.float32),
             "labels": _labels(rng, TRAIN_B, config.vocab_size)}
    per_step = base_step_counts(config.num_layers)
    launches = train_phase("train", "base (768-d, 12 layers) dropout 0.1, SpecAugment, seed 0",
                           model, config, batch, per_step, STAGE2_STEPS, smi, remat=False)
    del model
    torch.cuda.empty_cache()
    card_vs_cpu(config)
    return launches


def layer_norm_cost(smi: str) -> None:
    """Phase 6b: the card's `layer_norm` (one fused `F.layer_norm`) held
    against `layer_norm_plain` (the JAX package's sequence of operations,
    what the CPU runs and the JAX-parity tests hold) on the same inputs at
    width 768: f32 output and input gradient within 1e-5, bf16 output
    within one bf16 step of its largest value; then both timed on bf16 input: device ms of a
    forward at a served (8, 384) and the base inference (16, 768) shape, of
    a forward and backward at the train step's (32, 768), the host ms to
    enqueue a forward, the kernels a forward launches (the profiler).  A
    base forward runs 25 layer norms."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    gamma = 1 + 0.1 * torch.randn(768, device=dev, generator=gen)
    beta = 0.1 * torch.randn(768, device=dev, generator=gen)
    fns = {"fused": lambda x: layer_norm(x, gamma, beta),
           "plain": lambda x: layer_norm_plain(x, gamma, beta)}
    out = {}
    for label, (b, t) in (("serve", (8, 384)), ("inference", (16, 768)), ("train", (32, 768))):
        x32 = (3 * torch.randn(b, t, 768, device=dev, generator=gen) + 1).requires_grad_(True)
        dy = torch.randn(b, t, 768, device=dev, generator=gen)
        got = {}
        for name, fn in fns.items():
            y = fn(x32)
            got[name] = (y.detach(), torch.autograd.grad(y, x32, dy)[0])
        err = (got["fused"][0] - got["plain"][0]).abs().max().item()
        grad_err = (got["fused"][1] - got["plain"][1]).abs().max().item()
        x = x32.detach().bfloat16()
        plain = fns["plain"](x).float()
        bf16_err = (fns["fused"](x).float() - plain).abs().max().item()
        bf16_step = 2.0 ** (math.floor(math.log2(plain.abs().max().item())) - 7)
        require(err <= 1e-5 and grad_err <= 1e-5 and bf16_err <= bf16_step,
                f"layer_norm {label}: fused vs plain {err}, gradient {grad_err}, bf16 {bf16_err}")
        out[label] = {"shape": [b, t, 768], "f32_max_abs_err": err,
                      "f32_grad_max_abs_err": grad_err, "bf16_max_abs_err": bf16_err,
                      "tol": {"f32": 1e-5, "bf16": bf16_step}}
        for name, fn in fns.items():
            rec = {"fwd_ms": time_ms(lambda: fn(x), 20)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn(x)
            rec["host_enqueue_ms"] = (time.perf_counter() - t0) * 1e3 / 20
            torch.cuda.synchronize()
            rec["kernels_per_fwd"] = profile_device(lambda: fn(x), 3, "call", top=1)[
                "kernel_launches_per_call"]
            if label == "train":
                xg = x.clone().requires_grad_(True)
                dyb = dy.bfloat16()
                rec["fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(fn(xg), xg, dyb), 10)
            out[label][name] = rec
        del x32, dy, got
    emit({"phase": "layer_norm", "card": smi, **out})


def _ragged_batch(rng, b: int, samples: int, shortest: int):
    """(speech (b, samples) f32, zero past each row's length; lengths), row 0
    at full length."""
    lengths = rng.integers(shortest, samples + 1, size=b)
    lengths[0] = samples
    speech = rng.standard_normal((b, samples)).astype(np.float32)
    speech[np.arange(samples)[None, :] >= lengths[:, None]] = 0.0
    return speech, lengths


def logits_vs(got: torch.Tensor, ref: torch.Tensor):
    """(max abs diff, mean abs diff, ref's max |logit|, share of frames with
    the same argmax) of two (frames, vocab) logit matrices."""
    got, ref = got.float().cpu(), ref.float().cpu()
    diff = (got - ref).abs()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    return diff.max().item(), diff.mean().item(), ref.abs().max().item(), agree


def robust_phases(model, smi: str):
    """Phase 7: the robust/large family through the evaluator's entry points
    and through the training step.  Returns {path: launch counts}."""
    dev = torch.device("cuda")
    config = model.config
    layers = config.num_layers
    per_forward = {"conv01_robust": 1, "pos_conv": 1, "flash_attention_fwd": layers}
    evaluator = GreedyCTCEvaluator(model)
    require(evaluator.compute_dtype == torch.bfloat16 and evaluator.use_attention_mask,
            "the robust card path runs in bf16 with a sample mask")
    rng = np.random.default_rng(7)
    speech, lengths = _ragged_batch(rng, ROBUST_B, SAMPLES, 80000)
    words = ["A", "IT", "THE", "CAT", "HELLO", "WORLD", "OF"]
    corpus = [(rng.standard_normal(int(n)).astype(np.float32),
               " ".join(rng.choice(words, size=int(rng.integers(2, 12)))))
              for n in rng.integers(20000, SAMPLES + 1, size=24)]
    buckets = default_buckets()
    in_bucket = {}
    for audio, _ in corpus:
        bucket = next(bk for bk in buckets if len(audio) <= bk)
        in_bucket[bucket] = in_bucket.get(bucket, 0) + 1
    eval_forwards = sum(-(-n // ROBUST_B) for n in in_bucket.values())

    reset_counts()
    t = time.perf_counter()
    texts = evaluator.predict_batch(speech, lengths)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    expect_counts("one robust forward", read_counts(), per_forward)
    t = time.perf_counter()
    wer, n_scored = evaluator.evaluate_bucketed(corpus, batch_size=ROBUST_B)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    # a row of padding only decodes nothing
    tail = evaluator.predict_batch(speech[:2, :80000], np.array([80000, 0]))
    forwards = 1 + eval_forwards + 1
    launches = read_counts()
    expect_counts("the robust inference path", launches,
                  {k: v * forwards for k, v in per_forward.items()})
    require(len(texts) == ROBUST_B and all(isinstance(x, str) for x in texts),
            "predict_batch returned the wrong number of transcripts")
    require(n_scored == len(corpus) and np.isfinite(wer), f"evaluate_bucketed: {wer}, {n_scored}")
    require(tail[1] == "", f"a padded row decoded {tail[1]!r}")

    # steady-state forward of the ragged batch (device-synchronised host clock)
    x = torch.from_numpy(speech).to(dev)
    m = torch.from_numpy((np.arange(SAMPLES)[None, :] < lengths[:, None]).astype(np.float32)).to(dev)
    frames = config.conv_output_length(SAMPLES)

    def forward():
        with torch.inference_mode():
            return wav2vec2_for_ctc_forward(model, config, x, m, compute_dtype=torch.bfloat16)

    logits = forward()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()), "non-finite robust logits on the card")
    require(logits.shape == (ROBUST_B, frames, config.vocab_size), f"logits {tuple(logits.shape)}")
    reps = []
    for _ in range(10):
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t) * 1e3)
    fwd_ms = statistics.median(reps)
    row0 = logits[0].float().cpu()
    profile = profile_device(forward, 3, "forward")
    del x, m, logits

    # row 0 (full length) against the f32 CPU copy: the same seed gives the same weights
    cpu_model = Wav2Vec2ForCTC(config, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(
            cpu_model, config, torch.from_numpy(speech[:1]), torch.ones(1, SAMPLES),
            compute_dtype=torch.float32)[0]
    del cpu_model
    err, mean_err, scale, agree = logits_vs(row0, ref)
    # bf16 through 24 pre-norm layers against f32: twice the base model's
    # depth, so twice its limit (5% of the logit scale at 12 layers; measured
    # there 1.8-2.5%), and the greedy path on >= 90% of frames
    require(err <= 0.10 * scale and agree >= 0.9,
            f"robust card bf16 vs CPU f32: max {err} (scale {scale}), argmax agree {agree}")
    emit({"phase": "robust_main",
          "config": "robust/large (1024-d, 24 pre-norm layers, 16 heads, LayerNorm conv stack) seed 0",
          "batch": [ROBUST_B, SAMPLES], "lengths": lengths.tolist(),
          "launches_per_forward": per_forward, "forwards": forwards,
          "evaluate_bucketed": {"utterances": len(corpus), "per_bucket": in_bucket,
                                "forwards": eval_forwards, "seconds": eval_s, "wer": wer},
          "ms_per_forward": fwd_ms, "ms_per_forward_min_max": [min(reps), max(reps)],
          "forward_reps": len(reps),
          "audio_s_per_s_padded": ROBUST_B * SAMPLES / 16000 / (fwd_ms / 1e3),
          "audio_s_per_s_real": float(lengths.sum()) / 16000 / (fwd_ms / 1e3),
          "predict_batch_s": batch_s, "cpu_f32_max_abs_err": err, "cpu_f32_mean_abs_err": mean_err,
          "logit_scale": scale, "argmax_agree": agree, "card": smi})
    emit({"phase": "robust_profile", "card": smi, **profile})

    # training: the recipe's regularisation, the mask and length-aware CTC
    tconfig = RobustWav2Vec2Config()
    require(tconfig.dropout == 0.1 and tconfig.apply_spec_augment, "the recipe's regularisation")
    batch = {"speech": speech, "labels": _labels(rng, ROBUST_B, tconfig.vocab_size, 120),
             "attention_mask": (np.arange(SAMPLES)[None, :] < lengths[:, None]).astype(np.int32)}
    per_step = {"conv01_robust": 1, "pos_conv_train_fwd": 1, "pos_conv_dx": 1, "pos_conv_dw": 1,
                "flash_attention_fwd": layers, "flash_attention_bwd": layers, **CTC_STEP}
    train = train_phase(
        "robust_train", "robust/large (1024-d, 24 layers) dropout 0.1, SpecAugment, mask, seed 0",
        model, tconfig, batch, per_step, ROBUST_STAGE2_STEPS, smi,
        with_attention_mask=True, length_aware=True, remat=False)
    return {"robust_inference": launches, "robust_train": train}


def long_phases(smi: str):
    """Phase 8: 120 s of audio in one pass (5999 frames), base width at
    `LONG_LAYERS` layers: `predict_batch`, then a stage-2 step with dropout
    0.1; both also through the plain versions on the card.  Returns
    {path: launch counts}."""
    dev = torch.device("cuda")
    config = Wav2Vec2Config(num_layers=LONG_LAYERS, dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(config, device=dev, generator=torch.Generator().manual_seed(0))
    frames = config.conv_output_length(LONG_SAMPLES)
    rng = np.random.default_rng(11)
    clip = rng.standard_normal((1, LONG_SAMPLES)).astype(np.float32)
    per_forward = {"groupnorm_stats": 1, "fused_conv01": 1, "pos_conv": 1,
                   "flash_attention_fwd": LONG_LAYERS}
    evaluator = GreedyCTCEvaluator(model)
    reset_counts()
    t = time.perf_counter()
    text = evaluator.predict_batch(clip)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_counts()
    expect_counts("the long forward", launches, per_forward)
    require(len(text) == 1 and isinstance(text[0], str), "predict_batch on the long clip")

    x = torch.from_numpy(clip).to(dev)

    def forward():
        with torch.inference_mode():
            return wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)

    logits = forward()
    reps = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t) * 1e3)
    with plain_kernels():
        plain = forward()
    torch.cuda.synchronize()
    require(logits.shape == (1, frames, config.vocab_size) and bool(torch.isfinite(logits).all()),
            f"long logits {tuple(logits.shape)}")
    err, mean_err, scale, agree = logits_vs(logits[0], plain[0])
    # two bf16 paths that round at other places, 4 layers: 3% of the logit
    # scale (the 12-layer model against f32 is held to 5%), same greedy path
    # on >= 90% of frames
    require(err <= 0.03 * scale and agree >= 0.9,
            f"long forward, kernels vs plain: max {err} (scale {scale}), argmax agree {agree}")
    fwd_ms = statistics.median(reps)
    emit({"phase": "long_main", "config": f"base width, {LONG_LAYERS} layers, seed 0",
          "batch": [1, LONG_SAMPLES], "frames": frames, "launches_per_forward": per_forward,
          "ms_per_forward": fwd_ms, "ms_per_forward_min_max": [min(reps), max(reps)],
          "forward_reps": len(reps), "audio_s_per_s": LONG_SAMPLES / 16000 / (fwd_ms / 1e3),
          "predict_batch_s": first_s, "plain_path_max_abs_err": err,
          "plain_path_mean_abs_err": mean_err, "logit_scale": scale, "argmax_agree": agree,
          "card": smi})
    del logits, plain, x
    torch.cuda.empty_cache()

    # one stage-2 loss + gradient through the kernels and through the plain
    # versions: same weights, same batch, same generator seed (so the same
    # dropout bits and SpecAugment spans)
    tconfig = Wav2Vec2Config(num_layers=LONG_LAYERS)
    batch = {"speech": clip, "labels": _labels(rng, 1, tconfig.vocab_size)}
    mask = set_trainable(model, STAGE2)
    loss_fn = make_ctc_loss_fn(tconfig, division_factor=1, remat=False)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, torch.Generator().manual_seed(0))
        loss.backward()
        grads = torch.cat([p.grad.detach().double().flatten()
                           for n, p in model.named_parameters() if mask[n] and p.grad is not None])
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    card_loss, card_grads = loss_and_grads()
    with plain_kernels():
        plain_loss, plain_grads = loss_and_grads()
    rel = abs(card_loss - plain_loss) / abs(plain_loss)
    cos = (card_grads @ plain_grads / (card_grads.norm() * plain_grads.norm())).item()
    rel_grad = ((card_grads - plain_grads).norm() / plain_grads.norm()).item()
    # the limits of the base step against f32 (loss 1.5%, cosine 0.999)
    require(np.isfinite(card_loss) and rel <= 0.015 and cos >= 0.999,
            f"long step, kernels vs plain: loss {card_loss} vs {plain_loss}, grad cosine {cos}")
    del card_grads, plain_grads
    torch.cuda.empty_cache()

    per_step = {"groupnorm_stats": 1, "fused_conv01": 1, "pos_conv_train_fwd": 1, "pos_conv_dx": 1,
                "pos_conv_dw": 1, "flash_attention_fwd": LONG_LAYERS,
                "flash_attention_bwd": LONG_LAYERS, **CTC_STEP}
    st = create_train_state(model, create_optimizer(model, 1e-4))
    step = make_train_step(tconfig, division_factor=1, remat=False)
    gen = torch.Generator().manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    reset_counts()
    for i in range(4):
        counts = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, metrics = step(st, batch, gen)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        expect_counts(f"long stage-2 step {i}", counts_since(counts), per_step)
    train = read_counts()
    require(all(np.isfinite(losses)), f"long step losses {losses}")
    steady = times[1:]
    emit({"phase": "long_train", "config": f"base width, {LONG_LAYERS} layers, dropout 0.1, SpecAugment",
          "batch": [1, LONG_SAMPLES], "frames": frames, "launches_per_stage2_step": per_step,
          "losses": losses, "ms_per_stage2_step": statistics.median(steady),
          "ms_min_max": [min(steady), max(steady)], "steps_timed": len(steady),
          "first_step_ms": times[0], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "kernel_path_loss": card_loss, "plain_path_loss": plain_loss, "loss_rel_diff": rel,
          "grad_cosine_vs_plain_path": cos, "grad_rel_err_vs_plain_path": rel_grad, "card": smi})
    prof = profile_device(lambda: step(st, batch, gen), 1, "stage2_step", top=10_000)
    ctc_ms = sum(k["ms"] for k in prof["top"] if "ctc_" in k["kernel"])
    prof["top"] = prof["top"][:25]
    emit({"phase": "long_train_profile", "card": smi, **prof, "ctc_kernels_ms": ctc_ms,
          "ctc_share_of_device_busy": ctc_ms / prof["device_busy_ms_per_stage2_step"],
          "ctc_share_of_wall": ctc_ms / prof["wall_ms_per_stage2_step"]})
    return {"long_inference": launches, "long_train": train}


def _cosine(a: torch.Tensor, c: torch.Tensor) -> float:
    a, c = a.double().flatten(), c.double().flatten()  # f64: f32 sums over 1e8 elements drift past 1
    return (a @ c / (a.norm() * c.norm())).item()


def _rel_l2(a: torch.Tensor, c: torch.Tensor) -> float:
    """||a - c|| / ||c||: sees a scale error, which a cosine does not."""
    a, c = a.double().flatten(), c.double().flatten()
    return ((a - c).norm() / c.norm()).item()


def _pretrain_batch(config, args, seed: int, b: int = PRETRAIN_B):
    """A ragged (b, 246000) batch with its sample mask and the span mask
    `batch_masks` gives it (restricted to real frames)."""
    rng = np.random.default_rng(seed)
    speech, lengths = _ragged_batch(rng, b, SAMPLES, 80000)
    attention_mask = (np.arange(SAMPLES)[None, :] < lengths[:, None]).astype(np.int32)
    mti = batch_masks(torch.Generator().manual_seed(seed), torch.from_numpy(attention_mask),
                      config, args)
    return {"speech": speech, "attention_mask": attention_mask, "mask_time_indices": mti}, lengths


def check_scatter_kernels(records, smi: str):
    """Phase 9, first part: `scatter_rows_add` at the pretraining recipe's
    shapes (B=8, N = 768 frames x 100 negatives, D = 256 base / 768 large),
    f32 and bf16 cotangents, on the indices the port's own sampler gives a
    ragged batch: every unmasked frame sends its 100 copies to row 0; each
    also timed at uniform indices, and its three kernels (plan, sum, fixup)
    by the profiler."""
    dev = torch.device("cuda")
    config, args = Wav2Vec2PretrainingConfig(), PretrainingArgs()
    batch, _ = _pretrain_batch(config, args, seed=31)
    mti = batch["mask_time_indices"]
    b, l = mti.shape
    k = config.num_negatives
    gen = torch.Generator().manual_seed(97)
    negs = pt.sample_negative_indices(gen, mti, k)
    local = (negs - (torch.arange(b) * l)[:, None, None].to(torch.int32)).reshape(b, l * k)
    local = local.to(dev).contiguous()
    rows = (local.long() + torch.arange(b, device=dev)[:, None] * l).flatten()
    hot_share = (local == 0).float().mean().item()
    require(hot_share >= 0.3, f"the sampler's row 0 holds only {hot_share} of the sources")

    # duplicate-heavy and one-index cases (N = 1000: no multiple of anything)
    small = torch.randn(3, 1000, 128, generator=gen).to(dev)
    sidx = torch.randint(0, 64, (3, 1000), generator=gen).to(torch.int32)
    sidx[1] = 7
    sidx[2, ::2] = 63
    sidx = sidx.to(dev)
    for x in (small, small.to(torch.bfloat16)):
        got = sa.scatter_rows_add(x, sidx, l_rows=64)
        want = sa.scatter_rows_add_plain(x, sidx, l_rows=64)
        torch.cuda.synchronize()
        err = errors(got, want)[0]
        # f32 sums of up to 1000 unit-scale addends in another order
        require(err <= 1e-5 * want.abs().max().item() and torch.equal(
            got, sa.scatter_rows_add(x, sidx, l_rows=64)), f"scatter_rows_add small {x.dtype}: {err}")

    cases = ((config.proj_codevector_dim, torch.float32, "scatter_rows_add"),
             (768, torch.float32, "scatter_rows_add_d768"),
             (config.proj_codevector_dim, torch.bfloat16, "scatter_rows_add_bf16"),
             (768, torch.bfloat16, "scatter_rows_add_bf16_d768"))
    for d, dtype, name in cases:
        dneg = torch.randn(b, l * k, d, generator=gen).to(dev, dtype)
        got = sa.scatter_rows_add(dneg, local, l_rows=l)
        again = sa.scatter_rows_add(dneg, local, l_rows=l)
        want = sa.scatter_rows_add_plain(dneg, local, l_rows=l)
        exact = torch.zeros(b * l, d, dtype=torch.float64, device=dev).index_add_(
            0, rows, dneg.reshape(-1, d).double()).reshape(b, l, d)
        torch.cuda.synchronize()
        require(got.shape == (b, l, d) and got.dtype == torch.float32, f"{name}: {tuple(got.shape)}")
        bit_equal = torch.equal(got, again)
        require(bit_equal, f"{name}: two launches on the same inputs differ")
        empty = torch.ones(b, l, dtype=torch.bool, device=dev)
        empty.scatter_(1, local.long(), False)
        require(bool(empty.any()) and not bool(got[empty].any()), f"{name}: a row without a source is not 0")
        scale = exact.abs().max().item()
        err64 = (got.double() - exact).abs().max().item()
        plain64 = (want.double() - exact).abs().max().item()
        err, mean_err = errors(got, want)
        # f32 sums of up to ~50000 unit-scale addends (row 0) in another order
        # than the plain version's atomics: 2e-5 of the output's scale between
        # the two, 1e-5 against the f64 sum
        tol = 2e-5 * scale
        require(err <= tol and err64 <= 1e-5 * scale, f"{name}: err {err} (f64 {err64}, scale {scale})")
        del want, exact, again, empty
        nbytes = dneg.numel() * dneg.element_size() + local.numel() * 4 + got.numel() * 4
        bms, by = bound(nbytes, float(dneg.numel()), PEAK_F32)
        table = torch.zeros(b * l, d, device=dev)
        flat = dneg.reshape(-1, d)
        prof = profile_device(lambda: sa.scatter_rows_add(dneg, local, l_rows=l), 5, "call", top=8)
        by_kernel = {part: sum(t["ms"] for t in prof["top"] if part in t["kernel"])
                     for part in ("scatter_plan_kernel", "scatter_sum_kernel", "scatter_fixup_kernel")}
        records.append(dict(
            name=name, counter="scatter_rows_add", paths=("pretrain_gather",), route="cuda",
            source=CSRC + "scatter_add.cu", replaces=PALLAS + "scatter_add.py:87",
            shape=[b, l * k, d], l_rows=l, dtype=str(dtype).replace("torch.", ""),
            addends="f32, exact", sources_on_row_0=hot_share,
            max_abs_err=err, mean_abs_err=mean_err, tol=tol, output_scale=scale,
            max_abs_err_vs_f64=err64, plain_max_abs_err_vs_f64=plain64, bit_equal_relaunch=bit_equal,
            ms=time_ms(lambda: sa.scatter_rows_add(dneg, local, l_rows=l), 20),
            plain_ms=time_ms(lambda: sa.scatter_rows_add_plain(dneg, local, l_rows=l), 5, 1),
            bound_ms=bms, bound_by=by,
            # one `index_add_` into an f32 table; none takes bf16 rows into f32 sums
            library_ms=(time_ms(lambda: table.zero_().index_add_(0, rows, flat), 5, 1)
                        if dtype == torch.float32 else None),
            # the profiler's device ms a call of the three kernels
            plan_ms=by_kernel["scatter_plan_kernel"], sum_ms=by_kernel["scatter_sum_kernel"],
            fixup_ms=by_kernel["scatter_fixup_kernel"],
        ))
        # the same rows at uniform indices: what the skew costs
        uniform = torch.randint(0, l, (b, l * k), generator=gen).to(torch.int32).to(dev)
        records[-1]["ms_uniform_indices"] = time_ms(
            lambda: sa.scatter_rows_add(dneg, uniform, l_rows=l), 20)
        del dneg, got, table, flat, uniform
        torch.cuda.empty_cache()
    emit({"phase": "pretrain_kernels", "checked": [r["name"] for r in records[-len(cases):]],
          "records": records[-len(cases):], "card": smi})


def pretrain_phases(smi: str):
    """Phase 9: the base pretraining model at full width and depth, every
    parameter trainable.  Returns {path: launch counts}."""
    config, args = Wav2Vec2PretrainingConfig(), PretrainingArgs(warmup_steps=8)
    require(config.dropout == 0.1 and config.num_negatives == 100 and config.num_layers == 12
            and config.contrastive_logits_temperature == 0.1, "the base pretraining recipe")
    model = Wav2Vec2ForPreTraining(config, device="cuda", generator=torch.Generator().manual_seed(0))
    mask = set_trainable(model, ())
    require(all(mask.values()), "pretraining trains every parameter")
    batch, lengths = _pretrain_batch(config, args, seed=21)
    b = PRETRAIN_B
    layers = config.num_layers
    # the conv front end trains, so it runs as plain convolutions: its fused kernels show 0
    per_step = pretrain_step_counts(layers)
    state = create_train_state(model, create_pretrain_optimizer(
        model, 0.0, weight_decay=args.weight_decay, eps=args.adam_eps))
    schedule = pretrain_lr_schedule(args.lr, args.warmup_steps, 500_000)
    step = pt.make_pretrain_step(config, division_factor=b, with_attention_mask=True, remat=False)
    gen = torch.Generator().manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def one_step():
        set_learning_rate(state.optimizer, schedule(state.step))
        return step(state, batch, gen, gumbel_temperature(args, state.step))

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, parts, norms, times, lrs = [], [], [], [], []
    for i in range(1 + PRETRAIN_STEPS):
        counts = read_counts()
        lrs.append(schedule(state.step))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = one_step()
        losses.append(m["loss"].item())  # reads back: the step is done
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        norms.append(m["grad_norm"].item())
        parts.append({k: m[k].item() for k in pt.PART_NAMES})
        expect_counts(f"pretrain step {i}", counts_since(counts), per_step)
        if i == 0:  # optax counts from 0: the first update runs at learning rate 0
            require(all(torch.equal(p.detach(), before[n]) for n, p in model.named_parameters()),
                    "the update at learning rate 0 moved a parameter")
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(all(np.isfinite(losses + norms)), f"pretrain losses {losses}, grad norms {norms}")
    # the draws (Gumbel noise, negatives, dropout) differ from step to step:
    # falling, or flat within 2%
    require(losses[-1] <= 1.02 * losses[0], f"the pretraining loss rose: {losses}")
    perplexities = [p["codevector_perplexity"] for p in parts]
    require(all(2.0 <= x <= config.num_codevectors for x in perplexities),
            f"codevector perplexity {perplexities} outside [2, {config.num_codevectors}]")
    fe0 = model.wav2vec2.feature_extractor.conv_layers[0].conv.kernel
    for name, p in (("conv0 kernel", fe0), ("codevectors", model.quantizer.codevectors),
                    ("weight_proj", model.quantizer.weight_proj.kernel)):
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()) and
                p.grad.abs().sum().item() > 0, f"no finite non-zero gradient on the {name}")
    unmoved = [n for n, p in model.named_parameters() if torch.equal(p.detach(), before[n])]
    require(not unmoved, f"parameters that never moved: {unmoved}")
    del before
    steady = times[2:]
    step_ms = statistics.median(steady)
    emit({"phase": "pretrain",
          "config": "base pretraining (768-d, 12 layers, codebooks 2 x 320, 256-d projections, "
                    "100 negatives) dropout 0.1, seed 0, every parameter trainable",
          "batch": [b, SAMPLES], "lengths": lengths.tolist(),
          "masked_frames": int(batch["mask_time_indices"].sum()), "contrastive_impl": "gram",
          "learning_rates": lrs, "losses": losses, "parts": parts, "grad_norms": norms,
          "launches_per_step": per_step, "ms_per_step": step_ms,
          "ms_min_max": [min(steady), max(steady)], "steps_timed": len(steady),
          "first_steps_ms": times[:2],
          "audio_s_per_s_padded": b * SAMPLES / 16000 / (step_ms / 1e3),
          "audio_s_per_s_real": float(lengths.sum()) / 16000 / (step_ms / 1e3),
          "peak_memory_gb": peak_gb, "card": smi})
    emit({"phase": "pretrain_profile", "card": smi,
          **profile_device(one_step, 1, "step", top=30)})
    by_path = {"pretrain": launches}

    # -- pretrain_gather: one forward, the loss backed through three times ----
    dev = model.device
    dbatch = {n: torch.as_tensor(v).to(dev) for n, v in batch.items()}
    mti = dbatch["mask_time_indices"]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(5)
    states, quantized, perplexity, code_ids = pt.wav2vec2_for_pretraining_forward(
        model, config, dbatch["speech"], mti, dbatch["attention_mask"], training=True,
        generator=gen, gumbel_temperature=2.0, compute_dtype=torch.bfloat16, return_code_ids=True)
    states.retain_grad()
    quantized.retain_grad()
    negs = pt.sample_negative_indices(gen, mti, config.num_negatives)

    def back_through(impl, kernel):
        model.zero_grad(set_to_none=True)
        states.grad = quantized.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pt.pretraining_loss(states, quantized, perplexity, mti, negs, config,
                                   code_ids=code_ids, scatter_kernel=kernel,
                                   contrastive_impl=impl)["loss"]
        (loss / b).backward(retain_graph=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        grads["d_states"], grads["d_quantized"] = states.grad.clone(), quantized.grad.clone()
        return loss.item(), grads, ms

    k_loss, k_grads, k_ms = back_through("gather", True)
    expect_counts("the gather loss through the scatter kernel", read_counts(), {
        "pos_conv_train_fwd": 1, "flash_attention_fwd": layers, "pos_conv_dx": 1,
        "pos_conv_dw": 1, "flash_attention_bwd": layers, "scatter_rows_add": 1})
    a_loss, a_grads, a_ms = back_through("gather", False)
    g_loss, g_grads, g_ms = back_through("gram", None)
    launches = read_counts()
    expect_counts("pretrain_gather", launches, {
        "pos_conv_train_fwd": 1, "flash_attention_fwd": layers, "pos_conv_dx": 3,
        "pos_conv_dw": 3, "flash_attention_bwd": 3 * layers, "scatter_rows_add": 1})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(np.isfinite(k_loss) and all(bool(torch.isfinite(g).all()) for g in k_grads.values()),
            "non-finite loss or gradient on the gather path")
    # the three losses: the same forward, so only the loss's own arithmetic differs
    for name, other in (("index_add_", a_loss), ("gram", g_loss)):
        require(abs(other - k_loss) <= 1e-5 * abs(k_loss), f"loss {name} {other} vs kernel {k_loss}")
    # kernel against autograd's index backward, per tensor (f32 addends in
    # both: only the order of the sums differs); the key biases' gradient is
    # 0 in exact arithmetic, noise only
    held = [n for n in k_grads if not n.endswith("k_proj.bias")]
    cos = {n: _cosine(k_grads[n], a_grads[n]) for n in held}
    rel = {n: _rel_l2(k_grads[n], a_grads[n]) for n in held}
    worst_cos, worst_rel = min(cos, key=cos.get), max(rel, key=rel.get)
    require(cos[worst_cos] >= 0.9999 and rel[worst_rel] <= 0.01,
            f"scatter kernel vs index_add_: {worst_cos} cosine {cos[worst_cos]}, "
            f"{worst_rel} rel {rel[worst_rel]}")
    # gram against gather at the loss's inputs: 1e-3 of each gradient's scale
    gram_err = {}
    for n in ("d_states", "d_quantized"):
        scale = a_grads[n].abs().max().item()
        gram_err[n] = (g_grads[n] - a_grads[n]).abs().max().item() / scale
        require(gram_err[n] <= 1e-3, f"gram vs gather {n}: {gram_err[n]} of scale")
    gram_cos = {n: _cosine(g_grads[n], a_grads[n]) for n in held}
    worst_gram = min(gram_cos, key=gram_cos.get)
    emit({"phase": "pretrain_gather", "batch": [b, SAMPLES],
          "loss_kernel": k_loss, "loss_index_add": a_loss, "loss_gram": g_loss,
          "kernel_vs_index_add_min_cosine": cos[worst_cos], "its_tensor": worst_cos,
          "kernel_vs_index_add_max_rel_l2": rel[worst_rel], "its_rel_tensor": worst_rel,
          "kernel_vs_index_add_d_quantized_rel_l2": rel["d_quantized"],
          "gram_vs_gather_max_err_of_scale": gram_err,
          "gram_vs_gather_min_param_cosine": gram_cos[worst_gram], "its_gram_tensor": worst_gram,
          "loss_and_backward_ms": {"gather_kernel": k_ms, "gather_index_add": a_ms, "gram": g_ms},
          "launches": {n: c for n, c in launches.items() if c}, "peak_memory_gb": peak_gb,
          "card": smi})
    by_path["pretrain_gather"] = launches
    del k_grads, a_grads, g_grads, states, quantized, dbatch, model, state
    torch.cuda.empty_cache()
    pretrain_card_vs_cpu(config, args)
    return by_path


def pretrain_card_vs_cpu(base_config, args):
    """One deterministic pretraining loss + gradient (dropout 0; the Gumbel
    noise and the negatives come from one CPU generator seed, so both runs
    draw the same) on the card in bf16 and on the f32 CPU copy, B=1 x 246000."""
    config = Wav2Vec2PretrainingConfig(**{**base_config.__dict__, "dropout": 0.0})
    model = Wav2Vec2ForPreTraining(config, device="cuda", generator=torch.Generator().manual_seed(1))
    set_trainable(model, ())
    batch, _ = _pretrain_batch(config, args, seed=41, b=1)
    loss_fn = pt._make_pretrain_loss_fn(config, division_factor=1, with_attention_mask=True,
                                        compute_dtype=None)

    def run():
        model.zero_grad(set_to_none=True)
        loss, parts = loss_fn(model, batch, torch.Generator().manual_seed(0), 2.0)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu().flatten() for n, p in model.named_parameters()}
        with torch.no_grad():
            ids = pt.wav2vec2_for_pretraining_forward(
                model, config, torch.from_numpy(batch["speech"]).to(model.device),
                batch["mask_time_indices"], torch.from_numpy(batch["attention_mask"]).to(model.device),
                training=True, generator=torch.Generator().manual_seed(0), gumbel_temperature=2.0,
                compute_dtype=torch.bfloat16 if model.device.type == "cuda" else torch.float32,
                return_code_ids=True)[3].cpu()
        model.zero_grad(set_to_none=True)
        return loss.item(), {k: v.item() for k, v in parts.items()}, grads, ids

    card_loss, card_parts, card_grads, card_ids = run()
    model.to("cpu")
    cpu_loss, cpu_parts, cpu_grads, cpu_ids = run()
    names = [n for n in cpu_grads if not n.endswith("k_proj.bias")]
    cos = _cosine(torch.cat([card_grads[n] for n in names]), torch.cat([cpu_grads[n] for n in names]))
    per = {n: _cosine(card_grads[n], cpu_grads[n]) for n in names}
    worst = min(per, key=per.get)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    same_ids = (card_ids == cpu_ids).all(dim=-1).float().mean().item()
    # The loss is held as the stage-2 step's (1.5%).  The gradient is not held
    # at that step's 0.999: a codeword is an argmax over 320 logits from bf16
    # features, so a few percent of the frames pick another codeword than the
    # f32 copy does, and each of them changes a target and a set of masked
    # negatives.  With 95% of the frames agreeing the flattened gradients
    # still point the same way: cosine 0.95.
    require(np.isfinite(card_loss) and rel <= 0.015, f"card loss {card_loss} vs CPU {cpu_loss}")
    require(same_ids >= 0.95, f"only {same_ids} of the frames pick the CPU copy's codewords")
    require(cos >= 0.95, f"pretraining gradient cosine card vs CPU {cos}")
    emit({"phase": "pretrain_card_vs_cpu", "batch": [1, SAMPLES], "card_bf16_loss": card_loss,
          "cpu_f32_loss": cpu_loss, "loss_rel_diff": rel, "card_parts": card_parts,
          "cpu_parts": cpu_parts, "grad_cosine": cos, "min_tensor_cosine": per[worst],
          "min_tensor": worst, "frames_with_the_same_codewords": same_ids})


# the JAX tests' tiny_config (tests/utils.py): hidden 64 with 4 heads (D = 16),
# conv width 32, pos conv 16 groups (C/G = 4)
TINY = dict(vocab_size=32, hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
            filter_sizes=[32] * 7, num_conv_pos_embedding_groups=16, dropout=0.0,
            apply_spec_augment=False)


def tiny_phase(smi: str) -> None:
    """Phase 5b: a config that no kernel instance covers takes the plain op
    at every site on the card, as the JAX package takes XLA's: a bf16 batch
    through `predict_batch` and a stage-2 step with every kernel count 0
    (but the CTC kernels', which take any config), then an f32 forward (TF32
    off) against the f32 CPU copy."""
    dev = torch.device("cuda")
    config = Wav2Vec2Config(**TINY)
    d, cg = config.hidden_size // config.num_heads, config.hidden_size // config.num_conv_pos_embedding_groups
    require(not cf.supports(config) and not fa.supports(d, torch.bfloat16)
            and not pc.supports(config.hidden_size, config.num_conv_pos_embedding_groups,
                                torch.bfloat16, config.num_conv_pos_embeddings),
            "tiny_config is covered by a kernel instance")
    model = Wav2Vec2ForCTC(config, device=dev, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    speech = rng.standard_normal((4, 32000)).astype(np.float32)
    reset_counts()
    texts = GreedyCTCEvaluator(model).predict_batch(speech)
    torch.cuda.synchronize()
    expect_counts("the tiny_config forward", read_counts(), {})
    batch = {"speech": speech, "labels": _labels(rng, 4, config.vocab_size, longest=60)}
    set_trainable(model, STAGE2)
    state = create_train_state(model, create_optimizer(model, 1e-4))
    state, metrics = make_train_step(config, division_factor=4, remat=False)(
        state, batch, torch.Generator().manual_seed(0))
    loss = metrics["loss"].item()
    # the CTC kernels take any config: the step's loss goes through them
    expect_counts("the tiny_config stage-2 step", read_counts(), CTC_STEP)
    x = torch.from_numpy(speech[:2])
    with torch.inference_mode():
        card = wav2vec2_for_ctc_forward(model, config, x.to(dev), compute_dtype=torch.float32).cpu()
    expect_counts("the tiny_config f32 forward", read_counts(), CTC_STEP)
    model.to("cpu")
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.float32)
    err = (card - ref).abs().max().item()
    emit({"phase": "tiny_dispatch", "config": "tiny_config: hidden 64, 4 heads (D = 16), conv 32, "
          "C/G = 4", "head_dim": d, "pos_conv_channels_per_group": cg, "transcripts": len(texts),
          "stage2_loss": loss, "launches": read_counts(), "f32_vs_cpu_max_abs_err": err,
          "tol": 4e-3, "card": smi})
    # the JAX parity tests' logits tolerance (tests/test_parity.py)
    require(len(texts) == 4 and np.isfinite(loss) and err <= 4e-3,
            f"tiny_config on the card: loss {loss}, f32 logits {err} off the CPU")


def card_vs_cpu(base_config):
    """One deterministic stage-2 loss + gradient (dropout 0, SpecAugment
    off) on the card in bf16 and on the f32 CPU copy, B=1 x 246000."""
    config = Wav2Vec2Config(**{**base_config.__dict__, "dropout": 0.0, "apply_spec_augment": False})
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    batch = {"speech": rng.standard_normal((1, SAMPLES)).astype(np.float32),
             "labels": _labels(rng, 1, config.vocab_size)}
    mask = set_trainable(model, STAGE2)
    loss_fn = make_ctc_loss_fn(config, division_factor=1, remat=False)

    def grads():
        out = {n: p.grad.detach().float().cpu().flatten()
               for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    def forward():
        model.zero_grad(set_to_none=True)
        return loss_fn(model, batch, torch.Generator().manual_seed(0))

    loss = forward()
    loss.backward()
    card_loss, card_grads = loss.item(), grads()
    # a second forward, backed through the plain attention backward (bf16,
    # JAX's roundings): what isolates the kernel backward.  The forward is
    # bit-reproducible (no float atomics), so both backwards start from the
    # same loss bits
    kernel_bwd = fa.flash_attention_bwd
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        loss = forward()
        loss.backward()
    finally:
        fa.flash_attention_bwd = kernel_bwd
    second_loss = loss.item()
    require(second_loss == card_loss, f"two card forwards differ: {card_loss} vs {second_loss}")
    plain_grads = grads()
    del loss
    model.to("cpu")
    loss = forward()
    loss.backward()
    cpu_loss, cpu_grads = loss.item(), grads()
    require(card_grads.keys() == cpu_grads.keys() == plain_grads.keys() and
            all(mask[n] for n in cpu_grads), "the card and the CPU differ in which leaves get grads")

    names = list(cpu_grads)
    cos = _cosine(torch.cat([card_grads[n] for n in names]), torch.cat([cpu_grads[n] for n in names]))
    per = {n: _cosine(card_grads[n], cpu_grads[n]) for n in names}
    worst = min(per, key=per.get)
    # kernel against plain backward, per tensor; the key biases' gradient is
    # 0 in exact arithmetic (softmax ignores a per-row constant): noise only
    held = [n for n in names if not n.endswith("k_proj.bias")]
    vs_plain = {n: _cosine(card_grads[n], plain_grads[n]) for n in held}
    rel_plain = {n: _rel_l2(card_grads[n], plain_grads[n]) for n in held}
    worst_plain = min(vs_plain, key=vs_plain.get)
    worst_rel = max(rel_plain, key=rel_plain.get)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    emit({"phase": "train_card_vs_cpu", "batch": [1, SAMPLES], "card_bf16_loss": card_loss,
          "card_bf16_loss_second_forward": second_loss, "cpu_f32_loss": cpu_loss,
          "loss_rel_diff": rel,
          "grad_cosine": cos, "min_tensor_cosine": per[worst], "min_tensor": worst,
          "kernel_vs_plain_bwd_min_cosine": vs_plain[worst_plain], "its_tensor": worst_plain,
          "kernel_vs_plain_bwd_max_rel_err": rel_plain[worst_rel], "its_rel_tensor": worst_rel})
    # the kernel backward against the plain one through the same graph: f32
    # sums in another order and bf16 roundings of ds that flip (measured:
    # lowest per-tensor cosine 0.999996, a layer-6 k projection)
    require(vs_plain[worst_plain] >= 0.9999 and rel_plain[worst_rel] <= 0.01,
            f"kernel vs plain attention backward: {worst_plain} cosine {vs_plain[worst_plain]}, "
            f"{worst_rel} rel err {rel_plain[worst_rel]}")
    # bf16 through 12 layers and back against f32.  Measured: the card's
    # loss 0.0006-0.21% off the f32 one; flattened cosine 0.99991-0.99992
    require(rel <= 0.015 and cos >= 0.999, f"card vs CPU: loss rel {rel}, grad cosine {cos}")


# the synthetic corpus of the cli phase: utterances and their lengths in samples
CLI_TRAIN, CLI_VAL = 64, 32
CLI_SHORTEST, CLI_LONGEST = 160000, 246000
CLI_LABELS = (50, 200)  # ids a transcript
_CKPT = train_cli._CKPT_STRIDE  # the checkpoint key of one completed epoch
# the resumed run against the straight one, beside the bit-equality the
# phase requires: the median over the tensors the updates moved of
# ||straight - resumed|| / ||straight - resume point|| (`_update_rel_l2`).
# Measured (H100, 700 W) while F.ctc_loss's backward was not deterministic:
# a sound resume 0.0070-0.0128, two straight runs 0.0006; a resume with a
# fresh generator 0.113-0.122, which must fail it in every run
RESUME_MEDIAN_TOL = 0.04


def write_corpus(root: str, vocab: int, seed: int = 0):
    """Phase 10 (b): 96 seeded utterances (a sine at a random pitch plus
    noise, normalised as the loaders normalise, 160000-246000 samples; 50-200
    random ids of the vocabulary each) written with the port's
    `TFRecordWriter`: two training shards of 32 and one validation shard of
    32.  Returns (training shard paths, validation shard path, seconds, the
    training utterances' audio in seconds)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    processor = Wav2Vec2Processor(is_tokenizer=False)
    paths = [os.path.join(root, name) for name in
             ("train-0.tfrecord", "train-1.tfrecord", "val-0.tfrecord")]
    train_samples = 0
    for i, path in enumerate(paths):
        with native_io.TFRecordWriter(path) as w:
            for _ in range(32):
                n = int(rng.integers(CLI_SHORTEST, CLI_LONGEST + 1))
                train_samples += n if i < 2 else 0
                pitch = rng.uniform(100.0, 400.0)
                sig = (0.5 * np.sin(2 * np.pi * pitch * np.arange(n) / 16000)
                       + 0.1 * rng.standard_normal(n))
                label = rng.integers(1, vocab, size=int(rng.integers(CLI_LABELS[0], CLI_LABELS[1] + 1)))
                w.write(np.asarray(processor(sig), np.float32), label.astype(np.int32))
    return paths[:2], paths[2], time.perf_counter() - t0, train_samples / 16000


class _Counted:
    """Wrap `cli.train`'s step builder and its validation loss so that each
    update's and each validation pass's launches (and the update's host time,
    ending in a readback) are recorded."""

    def __init__(self):
        self.updates, self.vals = [], []

    def __enter__(self):
        self._make, self._val = train_cli.make_train_step, train_cli.evaluate_loss

        def make_step(*a, **kw):
            step = self._make(*a, **kw)

            def counted(state, batch, gen):
                before = read_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(state, batch, gen)
                metrics["loss"].item()
                self.updates.append((counts_since(before), (time.perf_counter() - t) * 1e3))
                return state, metrics

            return counted

        def val(*a, **kw):
            before = read_counts()
            out = self._val(*a, **kw)
            self.vals.append(counts_since(before))
            return out

        train_cli.make_train_step, train_cli.evaluate_loss = make_step, val
        return self

    def __exit__(self, *exc):
        train_cli.make_train_step, train_cli.evaluate_loss = self._make, self._val


def _state_dicts_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _rel_diffs(a: dict, b: dict) -> dict:
    """Per tensor: max |a - b| over max |a| (the relative max-abs difference)."""
    return {n: ((a[n].float() - b[n].float()).abs().max() / a[n].float().abs().max().clamp_min(1e-30)).item()
            for n in a}


def _update_rel_l2(a: dict, b: dict, start: dict) -> dict:
    """Per tensor that the updates moved: ||a - b|| over ||a - start||, two
    runs' difference against the change their updates made from `start`."""
    out = {}
    for n in a:
        moved = (a[n].float() - start[n].float()).norm()
        if moved > 0:
            out[n] = ((a[n].float() - b[n].float()).norm() / moved).item()
    return out


def _l2_summary(rel: dict) -> dict:
    worst = sorted(rel, key=rel.get, reverse=True)[:4]
    return {"tensors": len(rel), "median": statistics.median(rel.values()),
            "max": max(rel.values()), "worst": {n: rel[n] for n in worst}}


@contextlib.contextmanager
def _fresh_generator_on_restore(seed: int):
    """A planted fault: `CheckpointManager.restore` restores all but the
    step's generator, which starts again from `seed` (the stage's own)."""
    restore = CheckpointManager.restore

    def faulty(self, state_like, step=None):
        out = restore(self, state_like, step)
        state_like.generator.manual_seed(seed)
        return out

    CheckpointManager.restore = faulty
    try:
        yield
    finally:
        CheckpointManager.restore = restore


def _diff_summary(rel: dict) -> dict:
    worst = sorted(rel, key=rel.get, reverse=True)[:6]
    rest = {n: v for n, v in rel.items() if not n.endswith("k_proj.bias")}
    worst_rest = max(rest, key=rest.get)
    return {"tensors": len(rel), "differing": sum(v > 0 for v in rel.values()),
            "median_rel": statistics.median(rel.values()), "worst": {n: rel[n] for n in worst},
            "worst_but_k_proj_bias": {worst_rest: rest[worst_rest]},
            "k_proj_bias_max": max((v for n, v in rel.items() if n.endswith("k_proj.bias")), default=0.0)}


def _repeat_grads(model, config, batch, reps: int = 8) -> dict:
    """`reps` stage-2 losses and gradients of one batch from one seed, each
    against the first; and the CTC loss alone backed `reps` times from one
    set of logits."""
    loss_fn = make_ctc_loss_fn(config, division_factor=TRAIN_B,
                               remat=train_cli.remat_value(TrainingArgs()))
    grads = []
    for _ in range(reps):
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch, torch.Generator().manual_seed(7)).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    model.zero_grad(set_to_none=True)
    rel = [_rel_diffs(grads[0], g) for g in grads[1:]]
    dev = model.device
    with torch.no_grad():
        logits = wav2vec2_for_ctc_forward(model, config, torch.as_tensor(batch["speech"]).to(dev),
                                          compute_dtype=torch.bfloat16)
    ctc = []
    for _ in range(reps):
        x = logits.detach().clone().requires_grad_(True)
        lengths = torch.full((x.shape[0],), x.shape[1])
        ctc_loss_fn(x, torch.as_tensor(batch["labels"]).to(dev), lengths, config.pad_id).sum().backward()
        ctc.append(x.grad)
    return {"reps": reps,
            "grads_bit_equal": all(_state_dicts_equal(grads[0], g) for g in grads[1:]),
            "grads_max_rel_diff": max(max(r.values()) for r in rel),
            "ctc_grad_bit_equal": all(torch.equal(ctc[0], c) for c in ctc[1:]),
            "ctc_grad_max_abs_diff": max((ctc[0] - c).abs().max().item() for c in ctc[1:]),
            "ctc_grad_differing_elements": max(int((ctc[0] != c).sum()) for c in ctc[1:]),
            "ctc_grad_elements": ctc[0].numel(),
            # what reaches the bf16 backward: the loss is the SUM / batch
            "ctc_grad_bf16_flips": [int(((ctc[0] / TRAIN_B).bfloat16() != (c / TRAIN_B).bfloat16()).sum())
                                    for c in ctc[1:]]}


def cli_phase(smi: str) -> dict:
    """Phase 10: the command-line path a user runs, at full base width.
    Returns the launch counts of the two-stage run (c) and of (f)'s
    straight pretraining run, by path."""
    config = Wav2Vec2Config()  # base, the recipe's dropout 0.1 and SpecAugment
    per_forward = base_forward_counts(config.num_layers)
    # cli.train's default --remat --remat_policy dots: each layer's attention
    # forward runs again in the backward
    per_step = base_step_counts(config.num_layers, remat=True)
    per_stage1 = {**per_forward, **CTC_STEP}  # the head trains: the CTC backward runs
    per_val = {**per_forward, "ctc_loss_fwd": 1}
    with tempfile.TemporaryDirectory(prefix="w2v2_cli_") as root:
        # (a) weight round trip: save_pretrained, then from_pretrained onto the card
        model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
        model_dir = os.path.join(root, "model")
        t = time.perf_counter()
        model.save_pretrained(model_dir)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = Wav2Vec2ForCTC.from_pretrained(model_dir)
        load_s = time.perf_counter() - t
        require(loaded.device.type == "cuda", "from_pretrained did not land on the card")
        require(_state_dicts_equal(model.state_dict(), loaded.state_dict()),
                "the weights changed through save_pretrained / from_pretrained")
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, SAMPLES)).astype(
            np.float32)).cuda()
        with torch.inference_mode():
            want = wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)
            got = wav2vec2_for_ctc_forward(loaded, config, x, compute_dtype=torch.bfloat16)
        require(torch.equal(got, want) and bool(torch.isfinite(got).all()),
                "bf16 logits after the weight round trip differ from the in-memory model's")
        emit({"phase": "cli_weights", "batch": [B, SAMPLES], "logits_bit_equal": True,
              "msgpack_mb": os.path.getsize(os.path.join(model_dir, "jax_model.msgpack")) / 1e6,
              "save_s": save_s, "load_s": load_s, "card": smi})
        del model, loaded, x, want, got
        torch.cuda.empty_cache()

        # (b) the corpus
        train_shards, val_shard, corpus_s, train_audio_s = write_corpus(root, config.vocab_size)

        def args(tag, **kw):
            base = dict(model_id=model_dir, train_tfrecords=train_shards,
                        val_tfrecords=[val_shard], stage1_epochs=1, stage2_epochs=2,
                        batch_size_per_device=TRAIN_B, audio_maxlen=SAMPLES, logging_steps=1,
                        ckpt_dir=os.path.join(root, f"ckpt_{tag}"),
                        log_dir=os.path.join(root, f"logs_{tag}"))
            base.update(kw)
            return TrainingArgs(**base)

        # the loader alone: host ms to produce one batch of the training stream
        loader = train_cli._loader(args("loader"), train_shards, None)
        t = time.perf_counter()
        batches = list(loader(seed=0, drop_remainder=True))
        loader_ms = (time.perf_counter() - t) * 1e3 / len(batches)
        require(len(batches) == CLI_TRAIN // TRAIN_B and
                batches[0]["speech"].shape == (TRAIN_B, SAMPLES), "the loader's batches")

        # (c) two stages through cli.train.main, every launch accounted for
        straight = args("straight")
        reset_counts()
        t = time.perf_counter()
        with _Counted() as counted:
            train_cli.main(straight)
        run_s = time.perf_counter() - t
        launches = read_counts()
        stage1, stage2 = counted.updates[:2], counted.updates[2:]
        require(len(stage1) == 2 and len(stage2) == 4, f"{len(counted.updates)} updates")
        for i, (c, _) in enumerate(stage1):
            expect_counts(f"cli stage-1 update {i}", c, per_stage1)
        for i, (c, _) in enumerate(stage2):
            expect_counts(f"cli stage-2 update {i}", c, per_step)
        require(len(counted.vals) == 3, f"{len(counted.vals)} validation passes")
        for c in counted.vals:
            expect_counts("cli validation pass (one batch of 32)", c, per_val)
        total = {k: sum(c[k] for c, _ in counted.updates) + sum(c[k] for c in counted.vals)
                 for k in KERNELS}
        expect_counts("the whole cli run", launches, total)
        metrics = [json.loads(l) for l in open(os.path.join(straight.log_dir, "metrics.jsonl"))]
        losses = [m[k] for m in metrics for k in ("stage1/loss", "stage2/loss") if k in m]
        val_losses = [m[k] for m in metrics for k in ("stage1/val_loss", "stage2/val_loss") if k in m]
        waits = [m["stage2/data_wait_s"] / m["stage2/batches"] for m in metrics
                 if "stage2/data_wait_s" in m]
        require(len(losses) == 6 and len(val_losses) == 3 and np.all(np.isfinite(losses + val_losses)),
                f"losses {losses}, validation {val_losses}")
        # each stage as a user of cli.train sees it: all its updates (and the
        # audio they trained on) over its epochs' wall time, loader waits,
        # validation passes and checkpoints included
        rates = {}
        for stage, updates, epochs in ((1, stage1, straight.stage1_epochs),
                                       (2, stage2, straight.stage2_epochs)):
            wall = sum(m[f"stage{stage}/epoch_time"] for m in metrics if f"stage{stage}/epoch_time" in m)
            rates[f"stage{stage}"] = {"wall_s": wall, "updates": len(updates),
                                      "updates_per_s": len(updates) / wall,
                                      "audio_s_trained_per_s": epochs * train_audio_s / wall,
                                      "update_ms_median": statistics.median(ms for _, ms in updates)}
        step2_ms = rates["stage2"]["update_ms_median"]
        final_c = os.path.join(straight.ckpt_dir, "final")
        stage2_start = CheckpointManager(os.path.join(straight.ckpt_dir, "stage1")).restore_raw()["model"]
        shutil.rmtree(os.path.join(straight.ckpt_dir, "stage1"))

        # one stage-2 epoch under the profiler: the device's idle share
        model = Wav2Vec2ForCTC.from_pretrained(final_c)
        prof_args = args("profile")
        logger = MetricLogger(prof_args.log_dir)
        prof = profile_device(lambda: train_cli.run_stage(
            stage=2, args=prof_args, config=config, model=model, train_loader=loader,
            val_loader=None, logger=logger, epochs=1), 1, "epoch", top=8)
        logger.finish()
        shutil.rmtree(prof_args.ckpt_dir)

        # are two identical stage-2 updates' gradients bit-equal on the card?
        set_trainable(model, STAGE2)
        determinism = _repeat_grads(model, config, batches[0])
        del model, batches
        torch.cuda.empty_cache()
        emit({"phase": "cli", "batch": [TRAIN_B, SAMPLES], "corpus_utterances": [CLI_TRAIN, CLI_VAL],
              "corpus_write_s": corpus_s, "updates": [len(stage1), len(stage2)],
              "launches_per_stage1_update": per_stage1, "launches_per_stage2_update": per_step,
              "launches_per_validation_batch": per_val, "launches": launches,
              "run_s": run_s, "updates_per_s_whole_run": len(counted.updates) / run_s,
              "train_audio_s_an_epoch": train_audio_s, "rates": rates,
              "stage1_update_ms": [ms for _, ms in stage1], "stage2_update_ms": [ms for _, ms in stage2],
              # one stage-2 update alone (a per-layer number): its padded audio over its time
              "padded_audio_s_per_s_of_one_update": TRAIN_B * SAMPLES / 16000 / (step2_ms / 1e3),
              "loader_ms_per_batch": loader_ms, "data_wait_ms_per_batch": [w * 1e3 for w in waits],
              "losses": losses, "val_losses": val_losses,
              "epoch_profile": {k: prof[k] for k in ("wall_ms_per_epoch", "device_busy_ms_per_epoch",
                                                     "device_idle_share", "top")},
              "determinism": determinism, "card": smi})

        # (d) 1 stage-2 epoch, then --resume to 2; and that resume with a planted
        # fault, which the check must tell from the sound one
        first = args("resume", stage2_epochs=1)
        train_cli.main(first)
        run_d = first.ckpt_dir
        mgr = CheckpointManager(os.path.join(run_d, "stage2"))
        raw = mgr.restore_raw()
        model = Wav2Vec2ForCTC.from_pretrained(model_dir)
        set_trainable(model, STAGE2)
        state = create_train_state(model, create_optimizer(model, 1e-4),
                                   generator=torch.Generator().manual_seed(123))
        mgr.restore(state)
        saved_opt, opt = raw["optimizer"], state.optimizer.state_dict()
        require(state.step == raw["step"] == 2 and mgr.latest_step() == _CKPT,
                f"restored step {state.step}")
        require(_state_dicts_equal(model.state_dict(), raw["model"]), "restored weights differ")
        require(all(_state_dicts_equal(opt["state"][i], saved_opt["state"][i]) for i in saved_opt["state"])
                and opt["state"].keys() == saved_opt["state"].keys(), "restored Adam state differs")
        require(torch.equal(state.generator.get_state(), raw["generator"]), "restored generator differs")
        require(_state_dicts_equal(Wav2Vec2ForCTC.from_pretrained(
            os.path.join(run_d, "final")).state_dict(), raw["model"]),
            "the final directory differs from the last checkpoint's weights")
        resume_point = raw["model"]
        # the same computation twice: (c) and this run at their first stage-2 checkpoint
        straight_first = CheckpointManager(os.path.join(straight.ckpt_dir, "stage2")).restore_raw(_CKPT)["model"]
        control = _rel_diffs(straight_first, resume_point)
        control_l2 = _update_rel_l2(straight_first, resume_point, stage2_start)
        del model, state, raw, opt, saved_opt, straight_first, stage2_start
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(straight.ckpt_dir, "stage2"))
        fault_d = os.path.join(root, "ckpt_fault")
        for stage in ("stage1", "stage2"):  # checkpoints are never rewritten: links will do
            shutil.copytree(os.path.join(run_d, stage), os.path.join(fault_d, stage),
                            copy_function=os.link)
        resumed = args("resume2", resume=run_d)
        with _Counted() as counted:
            train_cli.main(resumed)
        # it resumed: two stage-2 updates (a stage-1 update launches no backward
        # kernel) and one validation pass, logged as steps 3 and 4 of stage 2
        require(len(counted.updates) == 2 and len(counted.vals) == 1,
                f"the resumed run made {len(counted.updates)} updates, {len(counted.vals)} validations")
        for i, (c, _) in enumerate(counted.updates):
            expect_counts(f"resumed update {i}", c, per_step)
        metrics = [json.loads(l) for l in open(os.path.join(resumed.log_dir, "metrics.jsonl"))]
        logged = [(k, m["step"]) for m in metrics for k in ("stage1/loss", "stage2/loss") if k in m]
        require(logged == [("stage2/loss", 3), ("stage2/loss", 4)], f"the resumed run logged {logged}")
        fault = args("fault", resume=fault_d)
        with _fresh_generator_on_restore(fault.seed + 2):
            train_cli.main(fault)
        a = Wav2Vec2ForCTC.from_pretrained(final_c, device="cpu").state_dict()
        b = Wav2Vec2ForCTC.from_pretrained(os.path.join(run_d, "final"), device="cpu").state_dict()
        f = Wav2Vec2ForCTC.from_pretrained(os.path.join(fault_d, "final"), device="cpu").state_dict()
        rel, l2, fault_l2 = _rel_diffs(a, b), _update_rel_l2(a, b, resume_point), _update_rel_l2(a, f, resume_point)
        resume_equal = _state_dicts_equal(a, b)
        emit({"phase": "cli_resume", "restored_state_bit_equal": True,
              "resumed_updates": 2, "resumed_logged": logged,
              "resumed_vs_straight_bit_equal": resume_equal,
              "tolerance": {"update_rel_l2_median": RESUME_MEDIAN_TOL},
              "resumed_vs_straight": {**_diff_summary(rel), "update_rel_l2": _l2_summary(l2)},
              "fresh_generator_fault_vs_straight": {**_diff_summary(_rel_diffs(a, f)),
                                                    "update_rel_l2": _l2_summary(fault_l2)},
              "straight_vs_straight_first_stage2_checkpoint": {
                  **_diff_summary(control), "update_rel_l2": _l2_summary(control_l2)},
              "card": smi})
        # the CTC kernels are deterministic, so is every other op of the step:
        # two identical updates, two straight runs and a resume all give the
        # same bits
        require(determinism["grads_bit_equal"] and determinism["ctc_grad_bit_equal"],
                f"two identical updates differ on the card: {determinism}")
        require(max(control.values()) == 0,
                f"two straight runs differ on the card: {_diff_summary(control)}")
        require(resume_equal, f"resumed run differs from the straight run: {_diff_summary(rel)}")
        # the coarser median check stays beside it, with its planted fault
        require(statistics.median(l2.values()) <= RESUME_MEDIAN_TOL,
                f"resumed run beyond the median tolerance: {_l2_summary(l2)}")
        require(statistics.median(fault_l2.values()) > RESUME_MEDIAN_TOL,
                f"a resume with a fresh generator passes the check: {_l2_summary(fault_l2)}")
        shutil.rmtree(os.path.join(run_d, "stage2"))
        shutil.rmtree(fault_d)

        # (e) cli.evaluate on final/ over the validation shard
        reports = {}
        for mode in ("bucketed", "single"):
            reset_counts()
            reports[mode] = evaluate_cli.main(["--model_dir", final_c, "--tfrecords", val_shard,
                                               "--mode", mode])
            got = read_counts()
            forwards = got["fused_conv01"]
            expect_counts(f"cli.evaluate --mode {mode}", got,
                          {k: v * forwards for k, v in per_forward.items()})
            require(reports[mode]["num_samples"] == CLI_VAL, f"{mode}: {reports[mode]}")
            require(mode != "single" or forwards == CLI_VAL, f"single mode ran {forwards} forwards")
            reports[mode]["forwards"] = forwards
        emit({"phase": "cli_evaluate", "reports": reports, "launches_per_forward": per_forward,
              "card": smi})

        # (f) the pretraining CLI on the same training shards
        pretrain_launches = pretrain_cli_phase(smi, train_shards, root)
    return {"cli": launches, "pretrain_cli": pretrain_launches}


PRETRAIN_CLI_ACCUM = 4  # the cli corpus's 64 utterances in batches of 8: 2 updates an epoch


def _pretrain_metrics(args) -> list:
    return [json.loads(l) for l in open(os.path.join(args.log_dir, "metrics.jsonl"))]


def pretrain_cli_phase(smi: str, train_shards, root: str) -> dict:
    """Phase 10 (f): `cli.pretrain.main` at full base width and depth with
    its default `--remat --remat_policy dots`, on the cli corpus's training
    shards: 2 epochs of 2 updates (4 microbatches of 8 each), EMA; the
    exports on the card; then a SIGTERM after the third update and
    `--resume`.  Returns the launch counts of the straight run."""
    config = Wav2Vec2PretrainingConfig()
    per_micro = pretrain_step_counts(config.num_layers, remat=True)

    def args(tag, **kw):
        return PretrainingArgs(**{**dict(
            train_tfrecords=train_shards, epochs=2, batch_size_per_device=PRETRAIN_B,
            grad_accum=PRETRAIN_CLI_ACCUM, audio_maxlen=SAMPLES, warmup_steps=2,
            ema_decay=0.999, logging_steps=1, ckpt_dir=os.path.join(root, f"pretrain_{tag}"),
            log_dir=os.path.join(root, f"pretrain_logs_{tag}")), **kw})

    straight = args("straight")
    require((straight.remat, straight.remat_policy) == (True, "dots"), "the CLI's default remat")
    reset_counts()
    t = time.perf_counter()
    pretrain_cli.main(straight)
    run_s = time.perf_counter() - t
    launches = read_counts()
    micro = 2 * CLI_TRAIN // PRETRAIN_B
    expect_counts("the pretraining CLI's run", launches, {k: v * micro for k, v in per_micro.items()})
    metrics = _pretrain_metrics(straight)
    losses = [m["pretrain/loss"] for m in metrics if "pretrain/loss" in m]
    temps = [m["pretrain/gumbel_temperature"] for m in metrics if "pretrain/gumbel_temperature" in m]
    require(len(losses) == 4 and np.all(np.isfinite(losses)), f"pretraining CLI losses {losses}")
    require(all(a > b for a, b in zip(temps, temps[1:])), f"the temperature did not anneal: {temps}")
    epochs = [m for m in metrics if "pretrain/epoch_time" in m]
    wall = sum(m["pretrain/epoch_time"] for m in epochs)
    waits = [m["pretrain/data_wait_s"] / m["pretrain/batches"] * 1e3 for m in epochs]

    # the exports load onto the card and give finite logits, one head in both
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, SAMPLES)).astype(
        np.float32)).cuda()
    heads = []
    for name in ("for_ctc", "for_ctc_ema"):
        model = Wav2Vec2ForCTC.from_pretrained(os.path.join(straight.ckpt_dir, name))
        require(model.device.type == "cuda", f"{name} did not load onto the card")
        with torch.inference_mode():
            logits = model(x)
        require(bool(torch.isfinite(logits).all()) and logits.shape[0] == 2, f"{name}: logits")
        heads.append(model.lm_head.kernel.detach().cpu())
        del model
    require(torch.equal(heads[0], heads[1]), "the EMA export's head differs from for_ctc's")

    # the loader alone: host ms to produce one batch of 8
    loader = LibriSpeechDataLoader(LibriSpeechDataLoaderArgs(
        from_tfrecords=True, tfrecords=train_shards, batch_size=PRETRAIN_B, audio_maxlen=SAMPLES))
    t = time.perf_counter()
    n_batches = sum(1 for _ in loader(seed=0, drop_remainder=True))
    loader_ms = (time.perf_counter() - t) * 1e3 / n_batches

    # SIGTERM after the third update (epoch 1, update 1), then --resume
    cut = args("cut")
    make = pretrain_cli.make_pretrain_accum_steps

    def make_accum(*a, **kw):
        init_fn, accum_fn, apply_fn = make(*a, **kw)
        done = []

        def apply(state, acc):
            out = apply_fn(state, acc)
            done.append(1)
            if len(done) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return init_fn, accum_fn, apply

    pretrain_cli.make_pretrain_accum_steps = make_accum
    try:
        pretrain_cli.main(cut)
    finally:
        pretrain_cli.make_pretrain_accum_steps = make
    last = CheckpointManager(os.path.join(cut.ckpt_dir, "pretrain")).latest_step()
    require(last == _CKPT + 1 and not os.path.exists(os.path.join(cut.ckpt_dir, "for_ctc")),
            f"the preempted run's last checkpoint {last}")
    resumed = args("resumed", resume=cut.ckpt_dir)
    pretrain_cli.main(resumed)
    logged = [m["step"] for m in _pretrain_metrics(resumed) if "pretrain/loss" in m]
    require(logged == [4], f"the resumed run logged updates {logged}")
    diffs = {}
    for name in ("for_ctc", "for_ctc_ema"):
        a = Wav2Vec2ForCTC.from_pretrained(os.path.join(straight.ckpt_dir, name), device="cpu")
        b = Wav2Vec2ForCTC.from_pretrained(os.path.join(cut.ckpt_dir, name), device="cpu")
        diffs[name] = {"bit_equal": _state_dicts_equal(a.state_dict(), b.state_dict()),
                       **_diff_summary(_rel_diffs(a.state_dict(), b.state_dict()))}
    emit({"phase": "pretrain_cli", "config": "base pretraining (768-d, 12 layers), dropout 0.1, "
          "seed 0, --remat --remat_policy dots", "batch": [PRETRAIN_B, SAMPLES],
          "grad_accum": PRETRAIN_CLI_ACCUM, "updates": 4, "microbatches": micro,
          "launches_per_microbatch": per_micro, "launches": launches, "losses": losses,
          "temperatures": temps, "run_s": run_s, "epochs_wall_s": wall,
          "updates_per_s": 4 / wall,
          "audio_s_per_s_padded": micro * PRETRAIN_B * SAMPLES / 16000 / wall,
          "loader_ms_per_batch": loader_ms, "data_wait_ms_per_batch": waits,
          "exports_finite_on_card": True, "resumed_logged_steps": logged,
          # JAX's own CLI tests do not hold a pretraining resume bit for bit: reported
          "resumed_vs_straight": diffs, "card": smi})
    torch.cuda.empty_cache()
    return launches


REMAT_POLICIES = (False, "full", "dots")
REMAT_STEPS = 3  # timed, after one warm-up step


def remat_cell(name: str, model, step_of, per_step_of, smi: str) -> None:
    """One warm-up and `REMAT_STEPS` timed steps under each remat policy from
    the same weights and generator seed, launch counts exact; the
    parameters after the first step must be bit-equal across the policies."""
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    first, out = None, {}
    for policy in REMAT_POLICIES:
        model.load_state_dict(init)
        step = step_of(policy)
        gen = torch.Generator().manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(1 + REMAT_STEPS):
            counts = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(gen)
            losses.append(m["loss"].item())  # reads back: the step is done
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            expect_counts(f"remat {name} {policy} step {i}", counts_since(counts), per_step_of(policy))
            if i == 0:
                after = {n: p.detach().clone() for n, p in model.named_parameters()}
                if first is None:
                    first = after
                else:
                    require(all(torch.equal(first[n], after[n]) for n in first),
                            f"remat {name}: the parameters after one step under {policy!r} "
                            "differ from remat off's")
                del after
        require(np.all(np.isfinite(losses)), f"remat {name} {policy}: losses {losses}")
        out[str(policy)] = {"ms_per_step": statistics.median(times[1:]), "ms_steps": times,
                            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "losses": losses}
    require(len({r["losses"][0] for r in out.values()}) == 1,
            f"remat {name}: the first step's loss differs across policies")
    emit({"phase": "remat", "cell": name, "policies": out,
          "params_after_one_step_bit_equal": True,
          "launches_per_step": {str(p): per_step_of(p) for p in REMAT_POLICIES}, "card": smi})
    del first, init
    torch.cuda.empty_cache()


def remat_phase(smi: str) -> dict:
    """Phase 12: remat off / "full" / "dots" on the base stage-2 step at
    B=32 x 246000 and on pretraining (base at B=8 and B=16, robust at B=8):
    ms a step and peak memory each, parameters bit-equal after one step.
    Returns the phase's launch counts."""
    reset_counts()
    config = Wav2Vec2Config()
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"speech": rng.standard_normal((TRAIN_B, SAMPLES)).astype(np.float32),
             "labels": _labels(rng, TRAIN_B, config.vocab_size)}

    def stage2_of(policy):
        set_trainable(model, STAGE2)
        st = create_train_state(model, create_optimizer(model, 1e-4))
        step = make_train_step(config, division_factor=TRAIN_B, remat=policy)
        return lambda gen: step(st, batch, gen)[1]

    remat_cell(f"base_stage2_b{TRAIN_B}", model, stage2_of,
               lambda p: base_step_counts(config.num_layers, remat=bool(p)), smi)
    del model
    args = PretrainingArgs()
    for cls, b in ((Wav2Vec2PretrainingConfig, PRETRAIN_B), (Wav2Vec2PretrainingConfig, 16),
                   (RobustWav2Vec2PretrainingConfig, PRETRAIN_B)):
        pconfig = cls()
        pmodel = Wav2Vec2ForPreTraining(pconfig, device="cuda",
                                        generator=torch.Generator().manual_seed(0))
        pbatch, _ = _pretrain_batch(pconfig, args, seed=31 + b, b=b)

        def pretrain_of(policy, pmodel=pmodel, pconfig=pconfig, pbatch=pbatch, b=b):
            set_trainable(pmodel, ())
            st = create_train_state(pmodel, create_pretrain_optimizer(
                pmodel, 5e-4, weight_decay=args.weight_decay, eps=args.adam_eps))
            step = pt.make_pretrain_step(pconfig, division_factor=b, with_attention_mask=True,
                                         remat=policy)
            return lambda gen: step(st, pbatch, gen, 2.0)[1]

        family = "robust" if pconfig.is_robust else "base"
        remat_cell(f"{family}_pretrain_b{b}", pmodel, pretrain_of,
                   lambda p, n=pconfig.num_layers: pretrain_step_counts(n, remat=bool(p)), smi)
        del pmodel
        torch.cuda.empty_cache()
    return read_counts()


SERVE_CLIENTS, SERVE_REQUESTS = 8, 64  # serve_bench's defaults
SERVE_STREAM_S, SERVE_PIECE_S = 40, 2
SERVE_BEAM_WIDTH = 8


def check_serve_kernels(model, records, max_batch: int, buckets, path: str = "serve"):
    """groupnorm_stats, fused_conv01, the inference pos conv and the flash
    forward against their plain versions at the server's batch shapes
    (max_batch x each bucket; no mask, as the base family serves), each
    launched twice (bit-equal), at phase 3's tolerances; each check is added
    to its record under `checked_at`, with `path`."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5678)
    fe = model.wav2vec2.feature_extractor.conv_layers
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    bias = (0.1 * torch.randn(kernel.shape[-1], generator=gen)).to(dev)
    heads = model.config.num_heads
    d = kernel.shape[-1] // heads
    by_name = {r["name"]: r for r in records}
    for bucket in buckets:
        x = torch.randn(max_batch, bucket, generator=gen).to(dev, torch.bfloat16)
        gn, c01, _ = frontend_checks(x, fe[0].conv.kernel, fe[0].layer_norm.gamma,
                                     fe[0].layer_norm.beta, fe[1].conv.kernel)
        del x
        t = model.config.conv_output_length(bucket)
        err, mean_err, tol, _ = pos_conv_eval_check(kernel, bias, ((max_batch, t),), "pos_conv", gen)
        q, kk, v = (torch.randn(max_batch, heads, t, d, generator=gen).to(dev, torch.bfloat16)
                    for _ in range(3))
        q = q * (2.0 * d ** -0.5)
        out, lse = fa.flash_attention_fwd(q, kk, v)
        again, _ = fa.flash_attention_fwd(q, kk, v)
        pout, plse = fa.flash_attention_fwd_plain(q, kk, v)
        torch.cuda.synchronize()
        require(torch.equal(out, again), f"flash {max_batch} x L={t}: two launches differ")
        ferr, fmean = errors(out, pout)
        lse_err, _ = errors(lse, plse)
        require(ferr <= 0.02 and lse_err <= 1e-3, f"flash {max_batch} x L={t}: {ferr} / lse {lse_err}")
        for name, check in (("groupnorm_stats", gn), ("fused_conv01", c01),
                            ("pos_conv", dict(max_abs_err=err, mean_abs_err=mean_err, tol=tol)),
                            ("flash_attention_fwd", dict(max_abs_err=ferr, mean_abs_err=fmean,
                                                         tol=0.02, lse_max_abs_err=lse_err))):
            shape = [max_batch, heads, t, d] if name == "flash_attention_fwd" else [max_batch, bucket]
            by_name[name].setdefault("checked_at", []).append(
                {"shape": shape, "path": path, **check, "relaunch_bit_equal": True})
        del q, kk, v, out, again, pout
    torch.cuda.empty_cache()


class _ServeProbe:
    """Phase 11's instruments on the serving path, installed for a `with`
    block: each evaluator `_step` (one forward: its batch shape and mode, host
    ms up to the copy to the host, and the launches inside it; the last
    full-bucket batch and its outputs are kept), the batcher's padding, each
    `predict_segments` (a dispatch: forward plus host decode), the handler's
    body parsing and normalisation, and each client request
    (`serve_bench._post`: client ms, body and reply)."""

    def __init__(self, evaluator, batcher, processor):
        self.ev, self.batcher, self.processor = evaluator, batcher, processor
        self.steps, self.pads, self.dispatches, self.parses, self.posts = [], [], [], [], []
        self.last_full = None

    def __enter__(self):
        ev, batcher = self.ev, self.batcher
        step, pad, segments = ev._step, batcher._pad, ev.predict_segments
        self._parse, self._post = parse, post = serve._parse_audio, serve_bench._post
        full = max(batcher.buckets)

        def timed_step(speech, mask, mode=None):
            before = read_counts()
            t = time.perf_counter()
            out = step(speech, mask, mode)
            self.steps.append({"shape": list(speech.shape), "mode": mode,
                               "ms": (time.perf_counter() - t) * 1e3, "launches": counts_since(before)})
            if speech.shape[1] == full and mode == "scored":
                self.last_full = (speech.copy(), out)
            return out

        def timed_pad(reqs, bucket):
            t = time.perf_counter()
            out = pad(reqs, bucket)
            self.pads.append((time.perf_counter() - t) * 1e3)
            return out

        def timed_segments(speech, lengths=None):
            n = len(self.steps)
            t = time.perf_counter()
            out = segments(speech, lengths)
            ms = (time.perf_counter() - t) * 1e3
            self.dispatches.append({"bucket": speech.shape[1], "ms": ms,
                                    "decode_ms": ms - sum(s["ms"] for s in self.steps[n:]),
                                    "rows": int(np.count_nonzero(lengths))})
            return out

        def timed_parse(body, content_type):
            t = time.perf_counter()
            audio, want_ts = parse(body, content_type)
            self.processor(audio)  # the handler's normalisation, timed beside the decode
            self.parses.append((time.perf_counter() - t) * 1e3)
            return audio, want_ts

        def timed_post(url, body, timeout_s):
            t = time.perf_counter()
            reply = post(url, body, timeout_s)
            end = time.perf_counter()
            self.posts.append({"client_ms": (end - t) * 1e3, "start": t, "end": end, "body": body,
                               **reply})
            return reply

        ev._step, batcher._pad, ev.predict_segments = timed_step, timed_pad, timed_segments
        serve._parse_audio, serve_bench._post = timed_parse, timed_post
        return self

    def __exit__(self, *exc):
        for obj, name in ((self.ev, "_step"), (self.batcher, "_pad"), (self.ev, "predict_segments")):
            delattr(obj, name)
        serve._parse_audio, serve_bench._post = self._parse, self._post

    def take_posts(self):
        posts, self.posts = self.posts, []
        return posts


def _latency(posts) -> dict:
    """Phase 11's end-to-end numbers of one load pass: its requests' latency
    percentiles, and requests and audio-seconds over the wall time from the
    first request's start to the last one's end."""
    wall = max(p["end"] for p in posts) - min(p["start"] for p in posts)
    client = [p["client_ms"] for p in posts]
    server = [p["latency_ms"] for p in posts]
    pct = serve_bench.percentile
    return {"requests": len(posts), "wall_s": wall,
            "client_ms": {"p50": pct(client, 50), "p95": pct(client, 95), "p99": pct(client, 99),
                          "max": max(client)},
            "server_latency_ms": {"p50": pct(server, 50), "p95": pct(server, 95),
                                  "p99": pct(server, 99)},
            "req_per_s": len(posts) / wall,
            "audio_s_per_s": sum(p["audio_seconds"] for p in posts) / wall,
            "mean_batched_with": statistics.mean(p["batched_with"] for p in posts)}


def _http(base: str, path: str, body: bytes, content_type: str) -> dict:
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def serve_phase(smi: str, records, root: str):
    """Phase 11: the HTTP server at full base width (768-d, 12 layers,
    random seed 0), in a thread of this process so that launches can be
    read; the model is saved to `<root>/model`, which phase 17 serves again.
    Returns the launch counts of its two load passes and the replies that
    phase 17 is held against: each payload body's transcript, the words of
    the timestamped request, the alignment and the stream."""
    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)
    per_forward = base_forward_counts(config.num_layers)
    processor = Wav2Vec2Processor(is_tokenizer=False)
    model_dir = os.path.join(root, "model")
    Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0)
                   ).save_pretrained(model_dir)
    torch.cuda.empty_cache()
    # cli.serve's own loading path, its default buckets, batch and window
    args = serve.parse_args(["--model_dir", model_dir])
    t = time.perf_counter()
    evaluator = serve.load_evaluator(args)
    load_s = time.perf_counter() - t
    model = evaluator.model
    require(model.device.type == "cuda" and evaluator.compute_dtype == torch.bfloat16,
            "the server must run on the card in bf16")
    buckets = [int(b) for b in args.buckets.split(",")]
    require(tuple(buckets) == serve.DEFAULT_BUCKETS and args.max_batch == 8
            and args.batch_window_ms == 20.0, f"serve defaults {args}")
    batcher = serve.DynamicBatcher(evaluator, buckets=buckets, max_batch=args.max_batch,
                                   window_ms=args.batch_window_ms)
    stats = {"model": model_dir, "buckets": buckets, "max_batch": args.max_batch,
             "beam_width": 0, "requests": 0, "streams": 0, "aligns": 0}
    streams = serve.StreamSessions(evaluator, device_lock=batcher.device_lock)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(
        batcher, processor, stats, streams=streams))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with _ServeProbe(evaluator, batcher, processor) as probe:
            t = time.perf_counter()
            batcher.warmup()
            warmup_s = time.perf_counter() - t
            warm = probe.steps[:]
            require([s["shape"] for s in warm] == [[args.max_batch, b] for b in buckets],
                     f"warmup forwards {[s['shape'] for s in warm]}")
            batcher.start()
            thread.start()
            check_serve_kernels(model, records, args.max_batch, buckets)
            payloads = serve_bench.make_payloads(serve_bench.DEFAULT_LENGTHS)
            probe.steps, probe.pads, probe.dispatches, probe.parses = [], [], [], []
            reset_counts()
            load = serve_bench.run_load(base, payloads, SERVE_CLIENTS, SERVE_REQUESTS)
            load_posts = probe.take_posts()
            baseline = serve_bench.run_load(base, payloads, 1,
                                            max(SERVE_REQUESTS // 4, len(payloads)), warmup=False)
            base_posts = probe.take_posts()
            torch.cuda.synchronize()
            launches = read_counts()
            steps, dispatches, pads, parses = probe.steps, probe.dispatches, probe.pads, probe.parses
            last_full = probe.last_full
        # the device's busy share under the 8 clients: one more pass, profiled
        load_profile = profile_device(lambda: serve_bench.run_load(
            base, payloads, SERVE_CLIENTS, SERVE_REQUESTS // 2, warmup=False), 1, "pass", top=6)
        require(load["errors"] == 0 and baseline["errors"] == 0, f"load errors: {load} {baseline}")
        require(len(load_posts) == SERVE_REQUESTS + len(payloads)
                and len(base_posts) == max(SERVE_REQUESTS // 4, len(payloads)),
                f"{len(load_posts)} / {len(base_posts)} replies")
        # every dispatch is one forward at (max_batch, bucket) with the exact launches
        require(len(steps) == len(dispatches) == len(pads) > 0, "dispatches and forwards")
        for i, s in enumerate(steps):
            require(s["mode"] == "scored" and s["shape"][0] == args.max_batch
                    and s["shape"][1] in buckets, f"serve dispatch {i}: {s}")
            expect_counts(f"serve dispatch {i}", s["launches"], per_forward)
        expect_counts("the serve load", launches,
                      {k: v * len(steps) for k, v in per_forward.items()})

        # (a) a body's transcript does not depend on its batch, and equals the
        # in-process decode of its audio alone in a (max_batch, bucket) batch
        served = {}
        for p in load_posts + base_posts:
            served.setdefault(p["body"], set()).add(p["transcription"])
        require(len(served) == len(payloads) and all(len(v) == 1 for v in served.values()),
                "one body served two transcripts")
        served = {body: texts.pop() for body, texts in served.items()}
        for _, body in payloads:
            speech = np.asarray(processor(native_io.decode_wav_bytes(body)[0]), np.float32)
            bucket = batcher._bucket_for(len(speech))
            batch, lengths = batcher._pad([serve._Request(speech)], bucket)
            with batcher.device_lock:
                want = evaluator.predict_segments(batch, lengths)[0][0]
            require(served[body] == want, f"served {served[body]!r} != in-process {want!r}")
        # the same row moved and its neighbours changed: bit-equal ids and log-probs
        speech, ((ids, maxlogp), _) = last_full
        moved = np.random.default_rng(3).standard_normal(speech.shape).astype(np.float32)
        moved[-1] = speech[0]
        with batcher.device_lock:
            (ids2, maxlogp2), _ = evaluator._step(moved, None, "scored")
        require(np.array_equal(ids2[-1], ids[0]), "a row's ids depend on its batch")
        row_logp_bit_equal = bool(np.array_equal(maxlogp2[-1], maxlogp[0]))

        # (b) the three step modes on the main batch of phase 4
        main_batch = np.random.default_rng(0).standard_normal((B, SAMPLES)).astype(np.float32)
        with batcher.device_lock:
            t = time.perf_counter()
            argmax_ids, _ = evaluator._step(main_batch, None, "argmax")
            argmax_ms = (time.perf_counter() - t) * 1e3
            (scored_ids, scored_max), _ = evaluator._step(main_batch, None, "scored")
            t = time.perf_counter()
            logprobs, _ = evaluator._step(main_batch, None, "logprobs")
            logprobs_ms = (time.perf_counter() - t) * 1e3
        top2 = np.sort(logprobs, axis=-1)[..., -2:]
        unique = top2[..., 1] > top2[..., 0]  # rounding can tie, never reorder
        require(np.array_equal(scored_ids, argmax_ids) and np.array_equal(
            logprobs.argmax(-1)[unique], argmax_ids[unique])
            and np.array_equal(logprobs.max(-1), scored_max), "the step modes disagree")

        # (c) word timestamps on a served request
        audio_s, body = payloads[2]
        ts = _http(base, "/v1/transcribe?timestamps=1", body, "audio/wav")
        words = ts["words"]
        require(ts["transcription"] == served[body]
                and [w["word"] for w in words] == ts["transcription"].split()
                and all(0 <= w["start"] < w["end"] <= ts["audio_seconds"] for w in words)
                and all(a["end"] <= b["start"] for a, b in zip(words, words[1:])),
                f"timestamps: {ts}")

        # (d) a stream of 2 s pieces, normalize "none": the offline transcript
        clip = np.random.default_rng(2).standard_normal(SERVE_STREAM_S * 16000).astype(np.float32)
        t = time.perf_counter()
        sid = _http(base, "/v1/stream", json.dumps({"normalize": "none"}).encode(),
                    "application/json")["session"]
        piece, partials = SERVE_PIECE_S * 16000, []
        for lo in range(0, len(clip), piece):
            partials.append(_http(base, f"/v1/stream/{sid}", clip[lo : lo + piece].tobytes(),
                                  "application/octet-stream")["partial"])
        final = _http(base, f"/v1/stream/{sid}/finish", b"", "application/json")
        stream_s = time.perf_counter() - t
        with batcher.device_lock:
            offline = evaluator.transcribe_long(clip)
        require(final["transcription"] == offline and offline
                and all(b.startswith(a) for a, b in zip(partials, partials[1:] + [offline])),
                "the stream's transcript differs from transcribe_long's")

        # (e) forced alignment of a served transcript (special tokens dropped:
        # the tokenizer has no spelling of them)
        body = max(served, key=lambda b: len(served[b].split()))
        text = " ".join(re.sub(r"</?s>|<unk>", " ", served[body]).split())
        aligned = _http(base, "/v1/align?transcript=" + urllib.parse.quote(text), body,
                        "audio/wav")
        words = aligned["words"]
        require(text and [w["word"] for w in words] == aligned["transcription"].split()
                and len(words) == len(text.split())
                and all(0 <= w["start"] < w["end"] <= aligned["audio_seconds"] for w in words)
                and all(a["end_frame"] <= b["start_frame"] for a, b in zip(words, words[1:])),
                f"alignment: {aligned}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    require(stats["requests"] == len(load_posts) + len(base_posts) + SERVE_REQUESTS // 2 + 1
            and stats["aligns"] == 1
            and stats["streams"] == 1, f"server stats {stats}")

    # (f) beam search with an LM on the card's log-probs of the main batch
    rng = np.random.default_rng(1)
    lm = CharNGramLM(4, config.vocab_size).fit(
        [[int(i) for i in rng.integers(4, config.vocab_size, size=int(rng.integers(20, 200)))]
         for _ in range(200)])
    beam = GreedyCTCEvaluator(model, beam_width=SERVE_BEAM_WIDTH, lm=lm, lm_weight=0.5)
    beam_steps = []
    beam_step = beam._step

    def timed_beam_step(*a):
        t = time.perf_counter()
        out = beam_step(*a)
        beam_steps.append((time.perf_counter() - t) * 1e3)
        return out

    beam._step = timed_beam_step
    t = time.perf_counter()
    beam_texts = beam.predict_batch(main_batch)
    beam_ms = (time.perf_counter() - t) * 1e3
    require(len(beam_texts) == B and len(beam_steps) == 1, "beam decode of the main batch")
    for i in range(2):  # the same search over phase (b)'s log-probs, on the host
        seq = ctc_prefix_beam_search(logprobs[i], SERVE_BEAM_WIDTH, config.pad_id, lm=lm,
                                     lm_weight=0.5)
        require(beam_texts[i] == evaluator.tokenizer.decode(np.asarray(seq), group_tokens=False),
                f"beam row {i}")

    # per layer: one forward at each bucket's batch shape, back to back (events)
    # and its device time alone (the profiler)
    bucket_ms, bucket_device_ms = {}, {}
    with torch.inference_mode():
        for bucket in buckets:
            x = torch.zeros(args.max_batch, bucket, device=model.device)
            forward = lambda: wav2vec2_for_ctc_forward(model, config, x,
                                                       compute_dtype=torch.bfloat16)
            bucket_ms[bucket] = time_ms(forward, 10)
            bucket_device_ms[bucket] = profile_device(forward, 3, "forward")["device_busy_ms_per_forward"]
    del model, evaluator, beam, x
    torch.cuda.empty_cache()

    by_bucket = {b: [s["ms"] for s in steps if s["shape"][1] == b] for b in buckets}
    emit({"phase": "serve", "config": "base (768-d, 12 layers) random seed 0",
          "buckets": buckets, "max_batch": args.max_batch, "window_ms": args.batch_window_ms,
          "model_load_s": load_s, "warmup_s": warmup_s,
          "warmup_first_forward_ms": {b: s["ms"] for b, s in zip(buckets, warm)},
          # run_load's first len(payloads) requests are its sequential warmup
          "load": {**_latency(load_posts[len(payloads):]), "clients": SERVE_CLIENTS,
                   "serve_bench": load},
          "baseline": {**_latency(base_posts), "clients": 1, "serve_bench": baseline},
          "load_profile": {"requests": SERVE_REQUESTS // 2, "clients": SERVE_CLIENTS,
                           **{k: load_profile[k] for k in ("wall_ms_per_pass", "device_busy_ms_per_pass",
                                                           "device_idle_share", "top")}},
          "dispatches": len(steps), "launches_per_dispatch": per_forward, "launches": launches,
          "dispatches_by_bucket": {b: len(v) for b, v in by_bucket.items()},
          "rows_per_dispatch_mean": statistics.mean(d["rows"] for d in dispatches),
          "per_layer_ms": {
              "forward_ms_by_bucket": bucket_ms, "forward_device_ms_by_bucket": bucket_device_ms,
              "step_host_ms_median_by_bucket": {b: statistics.median(v) for b, v in by_bucket.items() if v},
              "pad_host_ms_median": statistics.median(pads),
              "decode_host_ms_median": statistics.median(d["decode_ms"] for d in dispatches),
              "parse_and_normalise_host_ms_median": statistics.median(parses)},
          "card": smi})
    emit({"phase": "serve_checks", "transcripts_equal_in_process": True, "row_moved_ids_bit_equal": True,
          "row_moved_max_logprob_bit_equal": row_logp_bit_equal,
          "modes_agree_on": [B, SAMPLES], "logprobs_argmax_ties": int((~unique).sum()),
          "argmax_step_ms": argmax_ms, "logprobs_step_ms": logprobs_ms,
          "timestamps_words": len(ts["words"]), "stream": {"seconds_of_audio": SERVE_STREAM_S,
                                                           "piece_s": SERVE_PIECE_S,
                                                           "wall_s": stream_s, "equal_offline": True},
          "aligned_words": len(aligned["words"]),
          "beam": {"width": SERVE_BEAM_WIDTH, "lm_order": 4, "batch": [B, SAMPLES],
                   "forward_host_ms": beam_steps[0], "decode_host_ms": beam_ms - beam_steps[0],
                   "logprobs_copy_included": True},
          "card": smi})
    return launches, {"served": served, "timestamps": {"body": payloads[2][1], "reply": ts},
                      "align": {"body": body, "text": text, "reply": aligned},
                      "stream": {"partials": partials, "final": final["transcription"]}}


# facebook/hubert-large-ls960-ft's architecture fields, as its config.json gives them
HUBERT_LARGE = {
    "model_type": "hubert", "architectures": ["HubertForCTC"], "vocab_size": 32,
    "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
    "intermediate_size": 4096, "hidden_act": "gelu", "conv_dim": [512] * 7,
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
    "feat_proj_layer_norm": True, "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5, "pad_token_id": 0,
    "apply_spec_augment": True, "mask_time_prob": 0.05, "mask_time_length": 10,
}


def hubert_snapshot_model(fields: dict, config):
    """A raw HF snapshot of a HuBERT architecture (config.json of `fields`,
    pytorch_model.bin under HF's `hubert.` names, weights from seed 1 on the
    CPU) loaded by `from_pretrained` onto the card, bit for bit.  Returns the
    card's model, the CPU model, and the seconds to initialise, write and
    load."""
    t = time.perf_counter()
    ref = Wav2Vec2ForCTC(config, device="cpu", generator=torch.Generator().manual_seed(1))
    ref_sd = ref.state_dict()
    init_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory(prefix="w2v2_hubert_") as snap:
        t = time.perf_counter()
        names = hf_name_map(config, with_lm_head=True, prefix="hubert.")
        hf_sd = {theirs: fn(ref_sd[ours]).contiguous()
                 for ours, (theirs, fn) in names.items() if ours in ref_sd}
        require(len(hf_sd) == len(ref_sd), "every parameter has an HF name")
        torch.save(hf_sd, os.path.join(snap, "pytorch_model.bin"))
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(fields, f)
        del hf_sd
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        model = Wav2Vec2ForCTC.from_pretrained(snap)
        load_s = time.perf_counter() - t
    require(model.device.type == "cuda", "from_pretrained loads onto the card")
    require(all(torch.equal(v.cpu(), ref_sd[k]) for k, v in model.state_dict().items()),
            "the snapshot's weights did not load bit for bit")
    return model, ref, init_s, write_s, load_s


def hubert_phase(smi: str) -> dict:
    """Phase 13: a raw HF snapshot of `facebook/hubert-large-ls960-ft`'s
    architecture (config.json with model_type "hubert", pytorch_model.bin
    under HF's `hubert.` names, weights from seed 1) loaded by
    `from_pretrained` onto the card; a ragged B=8 x 246000 batch through
    `predict_batch` with its mask; launch counts a forward; ms a forward;
    row 0 against the f32 CPU forward at the robust cell's bounds.  Returns
    {"hubert": launch counts}."""
    config = config_from_hf_dict(HUBERT_LARGE)
    require(config.is_robust and config.feat_proj_layer_norm, "hubert-large is the robust family")
    layers = config.num_layers
    per_forward = {"conv01_robust": 1, "pos_conv": 1, "flash_attention_fwd": layers}
    model, ref, _, write_s, load_s = hubert_snapshot_model(HUBERT_LARGE, config)
    evaluator = GreedyCTCEvaluator(model)
    require(evaluator.compute_dtype == torch.bfloat16 and evaluator.use_attention_mask,
            "HuBERT-large runs in bf16 with a sample mask on the card")
    rng = np.random.default_rng(13)
    speech, lengths = _ragged_batch(rng, ROBUST_B, SAMPLES, 80000)
    reset_counts()
    t = time.perf_counter()
    texts = evaluator.predict_batch(speech, lengths)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    launches = read_counts()
    expect_counts("one HuBERT-large forward", launches, per_forward)
    require(len(texts) == ROBUST_B, "predict_batch returned the wrong number of transcripts")

    x = torch.from_numpy(speech).to("cuda")
    m = torch.from_numpy((np.arange(SAMPLES)[None, :] < lengths[:, None]).astype(np.float32)).cuda()

    def forward():
        with torch.inference_mode():
            return model(x, m)

    logits = forward()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()), "non-finite HuBERT logits on the card")
    reps = []
    for _ in range(10):
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t) * 1e3)
    row0 = logits[0].float().cpu()
    del x, m, logits, model, evaluator
    torch.cuda.empty_cache()
    with torch.inference_mode():
        want = wav2vec2_for_ctc_forward(ref, config, torch.from_numpy(speech[:1]),
                                        torch.ones(1, SAMPLES), compute_dtype=torch.float32)[0]
    del ref
    err, mean_err, scale, agree = logits_vs(row0, want)
    # the robust cell's bounds: 24 pre-norm layers in bf16 against f32
    require(err <= 0.10 * scale and agree >= 0.9,
            f"HuBERT card bf16 vs CPU f32: max {err} (scale {scale}), argmax agree {agree}")
    emit({"phase": "hubert", "config": "facebook/hubert-large-ls960-ft architecture (1024-d, "
          "24 stable-layer-norm layers, 16 heads, LayerNorm conv stack with bias), seed 1",
          "snapshot": ["config.json", "pytorch_model.bin"], "write_s": write_s,
          "from_pretrained_s": load_s, "batch": [ROBUST_B, SAMPLES], "lengths": lengths.tolist(),
          "launches_per_forward": per_forward, "predict_batch_s": batch_s,
          "ms_per_forward": statistics.median(reps), "ms_per_forward_min_max": [min(reps), max(reps)],
          "forward_reps": len(reps), "cpu_f32_max_abs_err": err, "cpu_f32_mean_abs_err": mean_err,
          "logit_scale": scale, "argmax_agree": agree, "card": smi})
    return {"hubert": launches}


# facebook/hubert-xlarge-ls960-ft's architecture fields, as its config.json
# gives them: the 1280-d family (as facebook/wav2vec2-xls-r-1b and
# facebook/mms-1b), 16 pos-conv groups of 80 channels, 16 heads of 80
HUBERT_XLARGE = {**HUBERT_LARGE, "hidden_size": 1280, "num_hidden_layers": 48,
                 "intermediate_size": 5120}
XLARGE_STAGE2_STEPS = 4  # phases 13b-13e
# the depth of phases 13b and 13c: their published 48 layers cut to 24 to hold
# the script inside its time limit (a layer more is one more of the same shapes;
# widths, heads, groups and FFN stay as published)
WIDE_LAYERS = 24
# the stage-2 step's remat: `cli.train`'s default ("dots").  Without remat the
# step peaked at 82.9 GB of the card's 85.0 (H100 80GB HBM3, phase 13b alone): too
# little room to promise late in this script
XLARGE_REMAT = "dots"


def xlarge_phase(smi: str, records) -> dict:
    """Phase 13b: a raw HF snapshot of `facebook/hubert-xlarge-ls960-ft`'s
    architecture (1280-d, `WIDE_LAYERS` of its 48 layers, weights from seed
    1) loaded by `from_pretrained` onto the card, bit for bit, through `wide_phases` at
    C/G = 80 (head dim 80: no flash instance, as in JAX), with
    `XLARGE_STAGE2_STEPS` stage-2 steps under `XLARGE_REMAT`.  Returns
    {path: launch counts}."""
    fields = {**HUBERT_XLARGE, "num_hidden_layers": WIDE_LAYERS}
    config = config_from_hf_dict(fields)
    _wide_geometry(config, 80)
    model, ref, init_s, write_s, load_s = hubert_snapshot_model(fields, config)
    n_params = sum(v.numel() for v in ref.state_dict().values())
    del ref  # the f32 reference runs on the card
    info = {"config": f"facebook/hubert-xlarge-ls960-ft architecture (1280-d, {WIDE_LAYERS} of its 48 "
                      "stable-layer-norm layers, 16 heads of 80, pos conv 16 groups of 80, LayerNorm "
                      "conv stack with bias), seed 1", "parameters": n_params,
            "snapshot": ["config.json", "pytorch_model.bin"], "init_s": init_s,
            "write_s": write_s, "from_pretrained_s": load_s}
    return wide_phases("xlarge", f"hubert-xlarge (1280-d, {WIDE_LAYERS} layers)", config, model, info,
                       80, smi, records, seed=17, remat=XLARGE_REMAT, steps=XLARGE_STAGE2_STEPS)


# facebook/wav2vec2-xls-r-2b's architecture fields, as its config.json gives
# them (XLS-R 1B's at 1920-d, arXiv:2111.09296 Table 1): 16 pos-conv groups of
# 120 channels, 16 heads of 120; the CTC head of the 32-symbol vocabulary
XLS_R_2B = {
    "model_type": "wav2vec2", "architectures": ["Wav2Vec2ForPreTraining"], "vocab_size": 32,
    "hidden_size": 1920, "num_hidden_layers": 48, "num_attention_heads": 16,
    "intermediate_size": 7680, "hidden_act": "gelu", "conv_dim": [512] * 7,
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
    "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5,
    "pad_token_id": 0, "apply_spec_augment": True, "mask_time_prob": 0.075, "mask_time_length": 10,
}
# the stage-2 step's remat: "full".  The f32 weights, gradients and Adam
# moments of ~2.16e9 parameters (full depth) alone are ~34.6 GB; "dots" at HuBERT-xlarge's
# rate (40.7 GB peak with 15.4 GB of that state) scales to ~73 GB here
XLS_R_2B_REMAT = "full"


def xls_r_2b_phase(smi: str, records) -> dict:
    """Phase 13c: `facebook/wav2vec2-xls-r-2b`'s architecture (1920-d,
    `WIDE_LAYERS` of its 48 layers) with a CTC head, weights from seed 1,
    through `wide_phases` at C/G = 120 (head dim 120: no flash instance, as
    in JAX), with `XLARGE_STAGE2_STEPS` stage-2 steps under
    `XLS_R_2B_REMAT`.  No snapshot: an f32 `pytorch_model.bin` of it would
    be ~8.6 GB at full depth.  Returns {path: launch counts}."""
    config = config_from_hf_dict({**XLS_R_2B, "num_hidden_layers": WIDE_LAYERS})
    _wide_geometry(config, 120)
    t = time.perf_counter()
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(1))
    init_s = time.perf_counter() - t
    info = {"config": f"facebook/wav2vec2-xls-r-2b architecture (1920-d, {WIDE_LAYERS} of its 48 "
                      "stable-layer-norm layers, 16 heads of 120, FFN 7680, pos conv 16 groups of 120, "
                      "LayerNorm conv stack with bias) with a CTC head of vocab 32, seed 1",
            "parameters": sum(p.numel() for p in model.parameters()), "init_s": init_s}
    return wide_phases("xls_r_2b", f"xls-r-2b (1920-d, {WIDE_LAYERS} layers)", config, model, info,
                       120, smi, records, seed=18, remat=XLS_R_2B_REMAT, steps=XLARGE_STAGE2_STEPS)


# facebook/wav2vec2-large-robust's widths with 8 heads of 128 in place of 16
# of 64: the one field that sets the head dim changed (no public wav2vec2 /
# XLS-R / HuBERT checkpoint has heads of 128)
H128_HEADS = 8
# the tile edges each head dim's kernels are checked at, on (2, 3, L, D)
FLASH_EDGES = (1, 63, 64, 65, 127, 128, 129, 1249)


def check_flash_head_dim_kernels(records, d: int, heads: int, b: int, phase: str, seed: int,
                                 train_b: int | None = None):
    """The flash kernels' head dim `d` instances, forward and backward,
    against their plain versions (`flash_dropout_errors`, every launch
    twice, bit-equal) at the phase's (b, heads, 768, d) with a ragged bias,
    without and with dropout 0.1, at (1, heads, 5999, d) with dropout (the
    long regime, where JAX switches to its kv-blocked kernels; hash stride
    6016) and at the tile edges L = `FLASH_EDGES` on (2, 3, L, d), no bias
    and ragged, dropout 0 and 0.1.  Timed at the phase's shape and the long
    one with their bounds and SDPA's time at the same shape (a yardstick
    the port never calls).  With `train_b`, the base family's training batch
    where it differs from `b`, also at (train_b, heads, 768, d) with no bias
    (the base family trains without a mask) and dropout 0.1.  Appends two
    records, `flash_attention_fwd_d{d}` (paths `phase` and `phase`_train) and
    `flash_attention_bwd_d{d}` (`phase`_train), the long regime, the training
    shape and the edges inside them."""
    gen = torch.Generator().manual_seed(seed)
    t = RobustWav2Vec2Config().conv_output_length(SAMPLES)
    rate, drop_seed = 0.1, 4321
    # -- the tile edges (at L = 1 dq = dk = 0 up to rounding: its gradients'
    # errors are recorded as they are, not over their scale) --------------------
    edge_fwd, edge_rel, l1_abs = 0.0, {"dq": 0.0, "dk": 0.0, "dv": 0.0}, 0.0
    for l in FLASH_EDGES:
        q, kk, v, dout = _peaky(2, 3, l, d, gen)
        for bias in (None, _ragged_bias(2, l, gen)):
            for r in (0.0, rate):
                (err, _), _, _, rel, gabs, _ = flash_dropout_errors(
                    q, kk, v, dout, bias, r, drop_seed,
                    f"d={d} L={l} bias={bias is not None} rate={r}", floor=1e-4, relaunch=True)
                edge_fwd = max(edge_fwd, err)
                if l == 1:
                    l1_abs = max(l1_abs, gabs)
                else:
                    edge_rel = {n: max(edge_rel[n], rel[n]) for n in rel}
    del q, kk, v, dout
    # -- the phase's shape: without dropout, then with it (and the backward) --
    q, kk, v, dout = _peaky(b, heads, t, d, gen)
    kb = _ragged_bias(b, t, gen)
    what = f"d={d} ({b}, {heads}, {t})"
    (err, mean_err), *_ = flash_dropout_errors(q, kk, v, dout, kb, 0.0, drop_seed, what, relaunch=True)
    (derr, _), _, _, rel, gabs, _ = flash_dropout_errors(q, kk, v, dout, kb, rate, drop_seed, what,
                                                         relaunch=True)
    run_flash = lambda: fa.flash_attention_fwd(q, kk, v, kb)
    run_library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, v, attn_mask=kb[:, None, None, :].to(q.dtype), scale=1.0)
    dev_ms, _ = device_kernels(run_flash)
    lib_dev_ms, lib_kernels = device_kernels(run_library)
    bms, by = bound(4 * q.numel() * 2 + b * heads * t * 4 + b * t * 4, 4 * b * heads * t * t * d,
                    PEAK_BF16)
    fwd = dict(
        name=f"flash_attention_fwd_d{d}", counter="flash_attention_fwd",
        paths=(phase, phase + "_train"),
        route="cuda", source=CSRC + "flash_attention.cu", replaces=PALLAS + "flash_attention.py:224",
        also_replaces=[PALLAS + "flash_attention.py:516"], head_dim=d,
        shape=[b, heads, t, d], ragged_bias=True, max_abs_err=err, mean_abs_err=mean_err, tol=0.02,
        relaunch_bit_equal=True, ms=time_ms(run_flash, 30), device_ms=dev_ms,
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(q, kk, v, kb), 3, 1),
        bound_ms=bms, bound_by=by, exp_bound_ms=exp_bound_ms(b * heads * t * t),
        library_ms=time_ms(run_library, 30), library_device_ms=lib_dev_ms,
        library_kernels=lib_kernels,
        edges=dict(shape=[2, 3, "L", d], checked_at_L=list(FLASH_EDGES), max_abs_err=edge_fwd,
                   bwd_max_rel_err_by_grad=edge_rel, bwd_max_abs_err_at_L1=l1_abs))
    out, lse = fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=drop_seed)
    fwd_rec, bwd_rec = flash_train_records(q, kk, v, dout, kb, out, lse, rate, drop_seed)
    fwd["dropout"] = dict(max_abs_err=derr, tol=0.04, **fwd_rec)
    bwd = dict(
        name=f"flash_attention_bwd_d{d}", counter="flash_attention_bwd", paths=(phase + "_train",),
        route="cuda", source=CSRC + "flash_attention.cu", replaces=PALLAS + "flash_attention.py:285",
        also_replaces=[PALLAS + "flash_attention.py:595", PALLAS + "flash_attention.py:638"],
        head_dim=d, max_abs_err=gabs, max_rel_err_by_grad=rel,
        tol="0.01 x each gradient's max |value|", relaunch_bit_equal=True, **bwd_rec)
    del q, kk, v, dout, kb, out, lse
    torch.cuda.empty_cache()
    # -- the long regime: (1, heads, 5999, d) with dropout -----------------------
    l = RobustWav2Vec2Config().conv_output_length(LONG_SAMPLES)
    q, kk, v, dout = _peaky(1, heads, l, d, gen)
    kb = _ragged_bias(1, l, gen)
    (lerr, _), out, lse, lrel, lgabs, _ = flash_dropout_errors(q, kk, v, dout, kb, rate, drop_seed,
                                                               f"d={d} L={l}", relaunch=True)
    fwd_rec, bwd_rec = flash_train_records(q, kk, v, dout, kb, out, lse, rate, drop_seed)
    fwd["long"] = dict(max_abs_err=lerr, tol=0.04, **fwd_rec)
    bwd["long"] = dict(max_abs_err=lgabs, max_rel_err_by_grad=lrel, **bwd_rec)
    del q, kk, v, dout, kb, out, lse
    if train_b is not None:
        fwd["train_shape"], bwd["train_shape"] = flash_train_batch_checks(
            train_b, heads, d, phase + "_train", gen)
    records.extend((fwd, bwd))
    torch.cuda.empty_cache()


def flash_train_batch_checks(b: int, heads: int, d: int, path: str, gen: torch.Generator):
    """The flash forward and backward at a base family's training shape (b,
    heads, 768, d) against their plain versions: no bias (the base family
    trains without a mask), dropout 0.1, every launch twice bit-equal.
    Returns the forward's and the backward's check, tagged with `path`."""
    t = RobustWav2Vec2Config().conv_output_length(SAMPLES)
    q, kk, v, dout = _peaky(b, heads, t, d, gen)
    (err, _), _, _, rel, gabs, _ = flash_dropout_errors(
        q, kk, v, dout, None, 0.1, 4321, f"d={d} ({b}, {heads}, {t}) no bias", relaunch=True)
    del q, kk, v, dout
    torch.cuda.empty_cache()
    shape = [b, heads, t, d]
    return (dict(shape=shape, path=path, ragged_bias=False, dropout=0.1, max_abs_err=err, tol=0.04,
                 relaunch_bit_equal=True),
            dict(shape=shape, path=path, ragged_bias=False, dropout=0.1, max_abs_err=gabs,
                 max_rel_err_by_grad=rel, relaunch_bit_equal=True))


def robust_h128_phase(smi: str, records) -> dict:
    """Phase 13d: `RobustWav2Vec2Config(num_heads=8)` (facebook/wav2vec2-
    large-robust's 1024-d, 24 pre-norm layers, FFN 4096, LayerNorm conv
    stack with bias, pos conv 16 groups of 64, with 8 heads of 128) as
    `Wav2Vec2ForCTC` of vocab 32, weights from seed 1: first the flash
    kernels' D = 128 instances (`check_flash_head_dim_kernels` at (8, 8,
    768, 128)), then `wide_phases` at C/G = 64 with the flash kernels at D =
    128 (24 forward launches a forward, 24 + 24 a stage-2 step), no remat, 4
    stage-2 steps; its pos-conv kernels' records are phase 7's (the same
    instance at the same shape), which this path's launches join.
    Returns {path: launch counts}."""
    config = RobustWav2Vec2Config(num_heads=H128_HEADS)
    require(config.hidden_size // config.num_heads == 128 and fa.supports(128, torch.bfloat16),
            "the card's dispatch takes the flash kernels at head dim 128")
    check_flash_head_dim_kernels(records, 128, H128_HEADS, ROBUST_B, "robust_h128", 12800)
    t = time.perf_counter()
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(1))
    info = {"config": "facebook/wav2vec2-large-robust's widths (1024-d, 24 pre-norm layers, FFN "
                      "4096, LayerNorm conv stack with bias, pos conv 16 groups of 64) with 8 heads "
                      "of 128 in place of 16 of 64, CTC head of vocab 32, seed 1",
            "parameters": sum(p.numel() for p in model.parameters()),
            "init_s": time.perf_counter() - t}
    cg = config.hidden_size // config.num_conv_pos_embedding_groups  # 64
    return wide_phases("robust_h128", "robust/large at 8 heads of 128", config, model, info, cg, smi,
                       records, seed=20, remat=False, steps=XLARGE_STAGE2_STEPS, pos_records=False)


# facebook/wav2vec2-base-960h's widths with 4 heads of 192 in place of 12 of
# 64, and facebook/wav2vec2-large-robust's with 4 of 256 in place of 16 of 64:
# the one field that sets the head dim changed (no public wav2vec2 / XLS-R /
# HuBERT checkpoint has heads of 192 or 256; the JAX package runs them on its
# Pallas kernels, as any multiple of 64).  base_h192 trains at B = ROBUST_B
# (8), the recipe's 32 cut to hold the script's time.
WIDE_HEADS = 4


def check_base_train_kernels_at(model, records, b: int, path: str) -> None:
    """The base family's kernels that a stage-1 and stage-2 step runs, against
    their plain versions at the training batch `b` x 246000 where phase 3
    holds them at 16 and 32 (base_h192: 8): `groupnorm_stats`,
    `fused_conv01` and the inference pos conv (stage 1's frozen forward)
    into their records' `checked_at`, and the C/G = 48 pos conv's training
    forward, dx and dW (dW sums over the batch) as records of their own
    (names ending `_cg48`, paths `path`), timed."""
    check_eval_kernels_at(model, records, b, path)
    gen = torch.Generator().manual_seed(8048)
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    with torch.no_grad():
        kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    bias = (0.1 * torch.randn(kernel.shape[-1], generator=gen)).to(model.device)
    frames = model.config.conv_output_length(SAMPLES)
    records.extend(pos_conv_train_records(kernel, bias, b, frames, f"_cg{kernel.shape[1]}", (path,),
                                          gen))
    del kernel, bias
    torch.cuda.empty_cache()


def wide_heads_phase(smi: str, records) -> dict:
    """Phase 13e: the flash kernels' D = 192 and 256 instances.  For each,
    first the kernels against their plain versions
    (`check_flash_head_dim_kernels` at (16, 4, 768, 192) and (8, 4, 768,
    256)), then a model at full width and depth with weights from seed 1
    through `wide_phases`: `Wav2Vec2Config(num_heads=4)` (base_h192:
    facebook/wav2vec2-base-960h's 768-d, 12 post-norm layers, FFN 3072,
    GroupNorm conv stack, pos conv 16 groups of 48, with 4 heads of 192)
    on B=16 x 246000 (flash forward 12 a forward), then 4 stage-2 steps at
    B=8 (12 + 12 a step), its front-end and pos-conv kernels held at B=8 first
    (`check_base_train_kernels_at`) and its flash kernels too;
    `RobustWav2Vec2Config(num_heads=4)` (robust_h256: the robust/large
    widths with 4 heads of 256) as phase 13d (24 a forward, 24 + 24 a step,
    4 steps).  No remat; their other pos-conv records are phase 3's (C/G =
    48, B=16) and phase 7's (C/G = 64, B=8), whose instances run here at
    those shapes.  Returns {path: launch counts}."""
    by_path = {}
    for phase, family, d, b, what in (
            ("base_h192", Wav2Vec2Config, 192, B,
             "facebook/wav2vec2-base-960h's widths (768-d, 12 post-norm layers, FFN 3072, GroupNorm "
             "conv stack, pos conv 16 groups of 48) with 4 heads of 192 in place of 12 of 64"),
            ("robust_h256", RobustWav2Vec2Config, 256, ROBUST_B,
             "facebook/wav2vec2-large-robust's widths (1024-d, 24 pre-norm layers, FFN 4096, "
             "LayerNorm conv stack with bias, pos conv 16 groups of 64) with 4 heads of 256 in "
             "place of 16 of 64")):
        config = family(num_heads=WIDE_HEADS)
        require(config.hidden_size // config.num_heads == d and fa.supports(d, torch.bfloat16),
                f"the card's dispatch takes the flash kernels at head dim {d}")
        base = not config.is_robust
        check_flash_head_dim_kernels(records, d, WIDE_HEADS, b, phase, 12800 + d,
                                     train_b=ROBUST_B if base else None)
        t = time.perf_counter()
        model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(1))
        info = {"config": what + ", CTC head of vocab 32, seed 1",
                "parameters": sum(p.numel() for p in model.parameters()),
                "init_s": time.perf_counter() - t}
        if base:
            check_base_train_kernels_at(model, records, ROBUST_B, phase + "_train")
        cg = config.hidden_size // config.num_conv_pos_embedding_groups
        by_path.update(wide_phases(phase, f"{phase} ({WIDE_HEADS} heads of {d})", config, model, info,
                                   cg, smi, records, seed=d, remat=False, steps=XLARGE_STAGE2_STEPS,
                                   pos_records=False, b=b))
        del model
        torch.cuda.empty_cache()
    return by_path


# Phase 13f: the conv01 instances at every multiple of 128 from 128 to 1024,
# and two full-width models driven through two of them: facebook/wav2vec2-
# base-960h's architecture with a 384-wide front end (the narrow kernel at a
# width 4 does not divide in atoms) and facebook/wav2vec2-large-robust's with
# a 1024-wide one (the wide kernel: columns over two CTAs, the LayerNorm
# split between them).  No public checkpoint has a front end other than 512
# wide; `filter_sizes` is the one field changed.
CONV_WIDTHS_B = ROBUST_B          # the instances' batch, x 246000 samples
CONV_EDGES = (1, 63, 64, 65, 129)  # conv1 rows: tile edges (64 rows a tile), odd tile counts
CONV_WIDTH_MODELS = {"base_c384": (Wav2Vec2Config, 384, B),
                     "robust_c1024": (RobustWav2Vec2Config, 1024, ROBUST_B)}
CONV_WIDTH_STEPS = 3  # stage-2 steps: two warm, one timed (`train_phase` times from the third)


def _front_pair(robust: bool, params, x):
    """(kernel, plain) calls of the family's conv01 wrapper on waveform x;
    the base family's scale and shift from `groupnorm_stats_plain` of x."""
    t0, t1 = cf.conv0_length(x.shape[1]), cf.conv1_length(x.shape[1])
    if robust:
        return (lambda: cf.conv01_robust(x, *params, t1, 1e-5, True),
                lambda: cf.conv01_robust_plain(x, *params, t1, 1e-5, True))
    w0, gamma, beta, w1 = params
    scale, shift = cf.groupnorm_stats_plain(x, t0, w0, gamma, beta, 1e-5)
    return (lambda: cf.conv01(x, w0, scale, shift, w1, t1, True),
            lambda: cf.conv01_plain(x, w0, scale, shift, w1, t1, True))


def conv_width_record(c: int, robust: bool, gen: torch.Generator) -> dict:
    """One conv01 instance (width c, the family's kernel) against its plain
    version at (CONV_WIDTHS_B, 246000) and at T1 = `CONV_EDGES` on one row
    (max error 0.05, mean 5e-3: bf16 outputs, ulp 2^-6 at |y| in [2, 4), over
    f32 sums in another order), launched twice bit-equal, timed beside its
    plain version, the library chain and its bound: max(bytes / 3.35 TB/s,
    2 B T1 (20 C + 3 C^2) FLOP / 989 TFLOP/s)."""
    dev = torch.device("cuda")
    params = front_params(torch, c, robust, gen, dev)
    edge_err = 0.0
    for t1e in CONV_EDGES:
        xe = torch.randn(1, 10 * t1e + 17, generator=gen).to(dev, torch.bfloat16)
        kern, plain = _front_pair(robust, params, xe)
        got, want = kern(), plain()
        require(got.shape == want.shape == (1, t1e, c), f"conv01 c{c} T1={t1e} shape {tuple(got.shape)}")
        err, mean_err = errors(got, want)
        require(err <= 0.05 and mean_err <= 5e-3, f"conv01 c{c} robust={robust} T1={t1e}: {err} / {mean_err}")
        edge_err = max(edge_err, err)
    b = CONV_WIDTHS_B
    x = torch.randn(b, SAMPLES, generator=gen).to(dev, torch.bfloat16)
    t1 = cf.conv1_length(SAMPLES)
    kern, plain = _front_pair(robust, params, x)
    got = kern()
    require(torch.equal(got, kern()), f"conv01 c{c} robust={robust}: two launches differ")
    want = plain()
    torch.cuda.synchronize()
    require(got.shape == (b, t1, c), f"conv01 c{c} shape {tuple(got.shape)}")
    err, mean_err = errors(got, want)
    del got, want
    require(err <= 0.05 and mean_err <= 5e-3, f"conv01 c{c} robust={robust}: err {err} / mean {mean_err}")
    norm_bytes = 6 * c * 4 if robust else 2 * b * c * 4
    nbytes = x.numel() * 2 + (10 * c + 3 * c * c) * 2 + norm_bytes + b * t1 * c * 2
    bms, by = bound(nbytes, 2 * b * t1 * (2 * 10 * c + 3 * c * c), PEAK_BF16)
    name = "conv01_robust" if robust else "fused_conv01"
    rec = dict(
        name=f"{name}_c{c}", counter=name, route="cuda", source=CSRC + "conv_frontend.cu",
        replaces=PALLAS + ("conv_frontend.py:334" if robust else "conv_frontend.py:251"),
        width=c, instance="conv01_wide_kernel" if c > 512 else "conv01_kernel",
        shape=[b, SAMPLES], max_abs_err=err, mean_abs_err=mean_err, tol=0.05,
        edges=dict(t1=list(CONV_EDGES), rows=1, max_abs_err=edge_err), relaunch_bit_equal=True,
        ms=time_ms(kern, 10), plain_ms=time_ms(plain, 2, 1), bound_ms=bms, bound_by=by,
        library_ms=time_ms(_front_library(robust, params, x), 10))
    del x, kern, plain
    torch.cuda.empty_cache()
    return rec


def groupnorm_width_record(c: int, gen: torch.Generator) -> dict:
    """`groupnorm_stats` at width c and (16, 246000) against its plain
    version (1e-5 of each output's scale), launched twice bit-equal, timed
    beside its bound (bytes: one pass over the waveform)."""
    dev = torch.device("cuda")
    w0, gamma, beta, _ = front_params(torch, c, False, gen, dev)
    x = torch.randn(B, SAMPLES, generator=gen).to(dev, torch.bfloat16)
    t0 = cf.conv0_length(SAMPLES)
    run = lambda: cf.groupnorm_stats(x, t0, w0, gamma, beta, 1e-5)
    got = run()
    require(all(torch.equal(u, v) for u, v in zip(got, run())), f"groupnorm_stats c{c}: two launches differ")
    want = cf.groupnorm_stats_plain(x, t0, w0, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    tol = 1e-5 * max(want[0].abs().max().item(), want[1].abs().max().item())
    err, mean_err = max(errors(got[0], want[0]), errors(got[1], want[1]))
    require(err <= tol, f"groupnorm_stats c{c}: max abs err {err} > {tol}")
    nbytes = x.numel() * 2 + (10 + 2) * c * 4 + 2 * B * c * 4
    bms, by = bound(nbytes, B * t0 * (2 * 55 + 10) + B * c * (2 * 10 + 2 * 110), PEAK_BF16)
    rec = dict(
        name=f"groupnorm_stats_c{c}", counter="groupnorm_stats", route="cuda",
        source=CSRC + "conv_frontend.cu", replaces=PALLAS + "conv_frontend.py:87",
        also_replaces=[PALLAS + "conv_frontend.py:239-249 (the XLA tail)"], width=c,
        shape=[B, SAMPLES], max_abs_err=err, mean_abs_err=mean_err, tol=tol, relaunch_bit_equal=True,
        ms=time_ms(run, 50), plain_ms=time_ms(lambda: cf.groupnorm_stats_plain(x, t0, w0, gamma, beta,
                                                                           1e-5), 5),
        bound_ms=bms, bound_by=by, library_ms=None)
    del x
    torch.cuda.empty_cache()
    return rec


def conv_widths_phase(smi: str, records) -> dict:
    """Phase 13f.  First every conv01 instance, C = 128 ... 1024 in both
    families (`conv_width_record`), and `groupnorm_stats` at 384 and 1024:
    the instances the two models below run become records of the kernels
    line (`fused_conv01_c384`, `groupnorm_stats_c384`, `conv01_robust_c1024`,
    with their paths), the others go into this phase's line with the same
    keys (launches 0: no path here runs them).  Then, through `wide_phases`
    with weights from seed 1, `Wav2Vec2Config(filter_sizes=[384] * 7)`
    (base_c384: B=16 x 246000, `groupnorm_stats`, `fused_conv01`, `pos_conv`
    1 each and flash 12 a forward) and `RobustWav2Vec2Config(filter_sizes=
    [1024] * 7)` (robust_c1024: a ragged B=8 batch with its mask,
    `conv01_robust` 1, `pos_conv` 1, flash 24): ms a forward, and with the
    front-end kernels turned off through `supports` (the plain layer loop);
    row 0 against the card's plain f32 forward; 1 stage-1 and 3 stage-2 steps
    at B=8 (the front end frozen: its kernels once a step); two identical
    stage-2 gradients bit-equal.  Before base_c384 runs, its front-end
    kernels are held at both its batches (16 and 8; `check_eval_kernels_at`
    into `checked_at` of the `_c384` records) and flash D = 64 at its steps'
    (8, 12, 768, 64) with dropout (`flash_train_batch_checks`).  Their pos-conv, flash and CTC kernels are
    those of the base and robust cells at the same shapes, whose records
    take these paths.  Returns {path: launch counts}."""
    t = time.perf_counter()
    gen = torch.Generator().manual_seed(1313)
    on_path = {("base_c384", False, 384), ("robust_c1024", True, 1024)}
    others = []
    for c in cf.KERNEL_WIDTHS:
        for robust in (False, True):
            rec = conv_width_record(c, robust, gen)
            phase = "robust_c1024" if robust else "base_c384"
            if (phase, robust, c) in on_path:
                records.append({**rec, "paths": (phase, phase + "_train")})
            else:
                others.append({**{k: v for k, v in rec.items() if k != "counter"}, "launches": 0})
    for c in (384, 1024):
        rec = groupnorm_width_record(c, gen)
        if c == 384:
            records.append({**rec, "paths": ("base_c384", "base_c384_train")})
        else:
            others.append({**{k: v for k, v in rec.items() if k != "counter"}, "launches": 0})
    emit({"phase": "conv_widths", "seconds": time.perf_counter() - t,
          "not_on_a_path": others, "card": smi})
    # the other kernels of the two models: the base and robust cells' records
    # at the same instances and shapes (flash at D = 64; pos conv C/G = 48 at
    # B=16 and, training at B=8, 13e's `_cg48`; C/G = 64 at B=8; CTC)
    joins = {"base_c384": ("pos_conv", "flash_attention_fwd"),
             "base_c384_train": ("pos_conv", "pos_conv_train_fwd_cg48", "pos_conv_dx_cg48",
                                 "pos_conv_dw_cg48", "flash_attention_fwd", "flash_attention_bwd"),
             "robust_c1024": ("pos_conv_cg64", "flash_attention_fwd"),
             "robust_c1024_train": ("pos_conv_cg64", "pos_conv_train_fwd_cg64", "pos_conv_dx_cg64",
                                    "pos_conv_dw_cg64", "flash_attention_fwd", "flash_attention_bwd")}
    by_name = {r["name"]: r for r in records}
    for path, names in joins.items():
        for n in names:
            by_name[n]["paths"] = tuple(by_name[n]["paths"]) + (path,)
    by_path = {}
    for phase, (family, c, b) in CONV_WIDTH_MODELS.items():
        config = family(filter_sizes=[c] * 7)
        require(cf.supports(config) and config.filter_sizes[0] == c,
                f"the card's dispatch takes the conv01 kernels at {c}")
        t = time.perf_counter()
        model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(1))
        what = ("facebook/wav2vec2-base-960h's architecture (768-d, 12 post-norm layers, 12 heads "
                "of 64, FFN 3072, GroupNorm conv stack, pos conv 16 groups of 48) with the front "
                "end 384 wide in place of 512" if c == 384 else
                "facebook/wav2vec2-large-robust's architecture (1024-d, 24 pre-norm layers, 16 "
                "heads of 64, FFN 4096, LayerNorm conv stack with bias, pos conv 16 groups of 64) "
                "with the front end 1024 wide in place of 512")
        info = {"config": what + ", CTC head of vocab 32, seed 1",
                "parameters": sum(p.numel() for p in model.parameters()),
                "init_s": time.perf_counter() - t}
        if not config.is_robust:
            # base_c384 runs its front end at B=16 (inference) and 8 (the
            # steps), where the instance records hold one each, and flash D =
            # 64 at the steps' (8, 12, 768, 64): each held at the other too
            check_eval_kernels_at(model, records, b, phase, front=f"_c{c}")
            check_eval_kernels_at(model, records, ROBUST_B, phase + "_train", front=f"_c{c}")
            checks = flash_train_batch_checks(ROBUST_B, config.num_heads,
                                              config.hidden_size // config.num_heads,
                                              phase + "_train", gen)
            for name, check in zip(("flash_attention_fwd", "flash_attention_bwd"), checks):
                by_name[name].setdefault("checked_at", []).append(check)
        cg = config.hidden_size // config.num_conv_pos_embedding_groups
        by_path.update(wide_phases(phase, f"{phase} (front end {c} wide)", config, model, info, cg,
                                   smi, records, seed=c, remat=False, steps=CONV_WIDTH_STEPS,
                                   pos_records=False, b=b, plain_site="front_end"))
        del model
        torch.cuda.empty_cache()
    return by_path


# Phase 13g: the pos-conv instances at 32, 96, 112 and 128 channels a group
# (JAX's Pallas kernels take any C/G), and two full-width models driven
# through two of them: facebook/wav2vec2-base-960h's architecture and
# facebook/wav2vec2-large-robust's, each with 8 pos-conv groups in place of
# 16 (C/G = 96 and 128).  No public checkpoint has these widths;
# `num_conv_pos_embedding_groups` is the one field changed.
POS_WIDTHS = (32, 96, 112, 128)
POS_WIDTHS_B = ROBUST_B  # the instances' batch, x 768 frames, in 16 groups
POS_EDGES = ((1, 63), (3, 129))  # (rows, T): a short T, an odd one over ragged dW splits
# phase -> (family, pos-conv groups, the forward's batch)
POS_WIDTH_MODELS = {"base_g8": (Wav2Vec2Config, 8, B), "robust_g8": (RobustWav2Vec2Config, 8, ROBUST_B)}
# Phase 13h: the odd multiples of 8 below 128 channels a group, which the
# kernels pad to whole k steps, and the same two architectures driven
# through two of them: base with its pos conv in 32 groups (C/G = 24),
# robust/large in 128 (C/G = 8)
POS_ODD8_WIDTHS = (8, 24, 40, 56, 72, 88, 104)
POS_ODD8_MODELS = {"base_g32": (Wav2Vec2Config, 32, B),
                   "robust_g128": (RobustWav2Vec2Config, 128, ROBUST_B)}
# the published architectures these models change (16 pos-conv groups)
POS_FAMILY = {False: "facebook/wav2vec2-base-960h's architecture (768-d, 12 post-norm layers, 12 heads "
                     "of 64, FFN 3072, GroupNorm conv stack)",
              True: "facebook/wav2vec2-large-robust's architecture (1024-d, 24 pre-norm layers, 16 heads "
                    "of 64, FFN 4096, LayerNorm conv stack with bias)"}
POS_WIDTH_STEPS = 3  # stage-2 steps: two warm, one timed
# the models' weights: seed 0, the base and robust cells' seed.  From seed 1
# base_g8's row-0 logits nearly tie between two classes over most frames,
# within the bf16 path's error of the f32 one, so the two forwards part on
# the argmax of many frames, on the CPU (where every site is plain) as on
# the card: the argmax check would measure the ties
POS_WIDTH_SEED = 0


def pos_width_records(cg: int, paths, gen: torch.Generator) -> list:
    """The four pos-conv kernels' C/G = `cg` instances at (`POS_WIDTHS_B`,
    768, 16 cg), K = 128, 16 groups, against their plain versions and timed
    beside them, the library calls and the bound (`pos_conv_eval_record`,
    `pos_conv_train_records`: also at 2 x 3000); then at `POS_EDGES` with K
    = 16 (at 128 also K = 132, the most taps the forward's window takes)
    into each record's `edges`.  Every launch twice, bit-equal.  Records
    named `_cg{cg}`; `paths` (the forward's, the steps') may be empty, and
    the inference kernel's record takes both (stage 1's forward runs it)."""
    dev = torch.device("cuda")
    c, t = 16 * cg, Wav2Vec2Config().conv_output_length(SAMPLES)

    def params(k):
        kernel = (torch.randn(k, cg, c, generator=gen) * (1.5 / (k * cg) ** 0.5)).to(dev)
        return kernel, (0.1 * torch.randn(c, generator=gen)).to(dev)

    kernel, bias = params(128)
    recs = [pos_conv_eval_record(kernel, bias, POS_WIDTHS_B, t, f"pos_conv_cg{cg}", paths, gen)]
    recs += pos_conv_train_records(kernel, bias, POS_WIDTHS_B, t, f"_cg{cg}", paths[1:], gen)
    edges = {r["counter"]: [] for r in recs}
    for k in (16, 132) if cg == 128 else (16,):
        kernel, bias = params(k)
        require(pc.supports(c, 16, torch.bfloat16, k), f"the card's dispatch takes C/G = {cg}, K = {k}")
        for rows, tt in POS_EDGES:
            err, _, tol, _ = pos_conv_eval_check(kernel, bias, ((rows, tt),), f"pos_conv_cg{cg} K={k}", gen)
            edges["pos_conv"].append(dict(shape=[rows, tt, c], taps=k, max_abs_err=err, tol=tol))
            checks, tols, _, _ = pos_conv_train_check(kernel, bias, rows, tt, f"_cg{cg} K={k}", gen)
            for name in ("pos_conv_train_fwd", "pos_conv_dx", "pos_conv_dw"):
                edges[name].append(dict(shape=[rows, tt, c], taps=k, max_abs_err=checks[name][0],
                                        tol=tols[name]))
    for r in recs:
        r["edges"] = edges[r["counter"]]
    torch.cuda.empty_cache()
    return recs


def check_pos_conv_at(model, records, b: int, path: str, train: bool) -> None:
    """The model's pos conv (its weight-normed kernel, its groups) against the
    plain versions at (b, 768, C), the shape its path gives it: the
    inference kernel or, with `train`, the training three, launched twice
    (bit-equal); each check is added under `checked_at` of the model's
    C/G record with `path`."""
    gen = torch.Generator().manual_seed(2323)
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    with torch.no_grad():
        kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
    k, cg, c = kernel.shape
    bias = (0.1 * torch.randn(c, generator=gen)).to(kernel.device)
    t = model.config.conv_output_length(SAMPLES)
    shape = dict(shape=[b, t, c], groups=c // cg, path=path, relaunch_bit_equal=True)
    by_name = {r["name"]: r for r in records}
    if train:
        checks, tols, _, _ = pos_conv_train_check(kernel, bias, b, t, f"_cg{cg} {path}", gen)
        for name in ("pos_conv_train_fwd", "pos_conv_dx", "pos_conv_dw"):
            by_name[f"{name}_cg{cg}"].setdefault("checked_at", []).append(
                {**shape, "max_abs_err": checks[name][0], "mean_abs_err": checks[name][1],
                 "tol": tols[name]})
    else:
        err, mean_err, tol, _ = pos_conv_eval_check(kernel, bias, ((b, t),), f"pos_conv_cg{cg} {path}", gen)
        by_name[f"pos_conv_cg{cg}"].setdefault("checked_at", []).append(
            {**shape, "max_abs_err": err, "mean_abs_err": mean_err, "tol": tol})
    del kernel, bias
    torch.cuda.empty_cache()


def pos_widths_phase(smi: str, records, widths=POS_WIDTHS, models=POS_WIDTH_MODELS,
                     name="pos_widths") -> dict:
    """Phases 13g (`POS_WIDTHS`, `POS_WIDTH_MODELS`) and 13h
    (`POS_ODD8_WIDTHS`, `POS_ODD8_MODELS`).  First the pos-conv kernels at
    every C/G in `widths` (`pos_width_records`): the instances that the
    models below run become records of the kernels line (`pos_conv_cg96`,
    `pos_conv_train_fwd_cg96`, ...), the others go into this phase's line
    (`name`) with the same keys (launches 0: no path here runs them).
    Then, through `wide_phases` with weights from `POS_WIDTH_SEED`, each
    model: `family(num_conv_pos_embedding_groups=groups)` (the base family
    at B=16 x 246000: `groupnorm_stats`, `fused_conv01`, `pos_conv` 1 each
    and flash 12 a forward; the robust/large one on a ragged B=8 batch with
    its mask: `conv01_robust` 1, `pos_conv` 1, flash 24): ms a forward, and
    with the pos-conv kernels turned off through `supports` (the plain
    conv, what the card ran at these widths before); row 0 against the
    card's plain f32 forward; 1 stage-1 and 3 stage-2 steps at B=8; two
    identical stage-2 gradients bit-equal.  Before each model runs, its own
    pos conv is held at its paths' shapes (`check_pos_conv_at`; the base
    family also its front end at B=8).  Their front-end, flash and CTC
    kernels are those of the base and robust cells at the same instances,
    whose records take these paths.  Returns {path: launch counts}."""
    t = time.perf_counter()
    gen = torch.Generator().manual_seed(2300)
    on_path = {family().hidden_size // groups: (phase, phase + "_train")
               for phase, (family, groups, _) in models.items()}
    others = []
    for cg in widths:
        recs = pos_width_records(cg, on_path.get(cg, ()), gen)
        if cg in on_path:
            records.extend(recs)
        else:
            others += [{**{k: v for k, v in r.items() if k not in ("counter", "paths")}, "launches": 0}
                       for r in recs]
    emit({"phase": name, "seconds": time.perf_counter() - t, "not_on_a_path": others, "card": smi})
    by_name = {r["name"]: r for r in records}
    for phase, (family, _, _) in models.items():
        front = ("conv01_robust",) if family().is_robust else ("groupnorm_stats", "fused_conv01")
        for path, flash in ((phase, ("flash_attention_fwd",)),
                            (phase + "_train", ("flash_attention_fwd", "flash_attention_bwd"))):
            for n in front + flash:
                by_name[n]["paths"] = tuple(by_name[n]["paths"]) + (path,)
    by_path = {}
    for phase, (family, groups, b) in models.items():
        config = family(num_conv_pos_embedding_groups=groups)
        cg = config.hidden_size // groups
        t = time.perf_counter()
        model = Wav2Vec2ForCTC(config, device="cuda",
                               generator=torch.Generator().manual_seed(POS_WIDTH_SEED))
        what = (f"{POS_FAMILY[config.is_robust]} with the pos conv in {groups} groups of {cg} in "
                f"place of 16 of {config.hidden_size // 16}")
        info = {"config": what + f", CTC head of vocab 32, seed {POS_WIDTH_SEED}",
                "parameters": sum(p.numel() for p in model.parameters()),
                "init_s": time.perf_counter() - t}
        if not config.is_robust:
            # the base family's steps run its front end and stage 1's pos
            # conv at B=8 (phase 3 holds the front end at 16 and 32)
            check_eval_kernels_at(model, records, ROBUST_B, phase + "_train", pos=f"pos_conv_cg{cg}")
        check_pos_conv_at(model, records, b, phase, train=False)
        check_pos_conv_at(model, records, ROBUST_B, phase + "_train", train=True)
        by_path.update(wide_phases(phase, f"{phase} (pos conv {groups} groups of {cg})", config, model,
                                   info, cg, smi, records, seed=cg, remat=False, steps=POS_WIDTH_STEPS,
                                   pos_records=False, b=b, plain_site="pos_conv",
                                   weights_seed=POS_WIDTH_SEED))
        del model
        torch.cuda.empty_cache()
    return by_path


def _wide_geometry(config, cg: int) -> None:
    """Phases 13b, 13c: `WIDE_LAYERS` stable-layer-norm layers, C/G = head
    dim = `cg`, which no flash instance takes (as in JAX)."""
    require(config.is_robust and config.num_layers == WIDE_LAYERS
            and config.hidden_size // config.num_conv_pos_embedding_groups == cg
            and config.hidden_size // config.num_heads == cg
            and not fa.supports(cg, torch.bfloat16), f"the {config.hidden_size}-d geometry")


@contextlib.contextmanager
def supports_off(mod):
    """The model sites' dispatch with no instance of `mod`'s kernels
    (`mod.supports` false), as JAX runs XLA where Pallas has no kernel: the
    card runs the seven conv layers as plain torch ops (`cf`),
    `flash_attention_fwd_plain` (`fa`) or `pos_conv_plain` through autograd
    (`pc`)."""
    saved = mod.supports
    mod.supports = lambda *args, **kwargs: False
    try:
        yield
    finally:
        mod.supports = saved


def wide_phases(phase, what, config, model, info, cg, smi, records, *, seed, remat, steps,
                pos_records=True, b=ROBUST_B, plain_site="attention", weights_seed=1) -> dict:
    """Models at full width on the card (phases 13b-13e), whose pos conv runs
    the kernels' C/G = `cg` instances and whose attention runs the flash
    kernels where `fa.supports` takes the head dim, else the plain version
    (as JAX runs XLA there).  The stable-layer-norm family: a ragged B=`b` x
    246000 batch through `predict_batch` with its mask (launches a forward:
    `conv01_robust` 1, `pos_conv` 1, flash forward one a layer or 0); the
    base family (no mask): a full-length one (`groupnorm_stats`,
    `fused_conv01`, `pos_conv` 1 each, flash as above).  ms a forward, and
    with flash also ms a forward of the plain attention (the flash kernels
    turned off through `fa.supports`), or with `plain_site` "front_end" of
    the plain conv layer loop (`cf.supports`) or "pos_conv" of the plain pos
    conv (`pc.supports`); row 0 against the card's plain f32
    forward (flash turned off: every site plain) at the family's cell's bounds (base 5% of the
    logit scale, robust 10%); with `pos_records` the four pos-conv kernels
    at (8, 768, C) against their plain versions, timed (into `records`,
    names ending `_cg{cg}`); one stage-1 and `steps` stage-2 steps of the
    batch's first `ROBUST_B` rows with dropout 0.1, SpecAugment and the
    family's mask (the three pos-conv training kernels and the CTC pair 1
    each a step, the base family's front-end kernels too, with flash the
    forward one a layer, two under remat, and the backward one a layer);
    two identical stage-2 losses and gradients bit-equal, all under
    `remat` (`weights_seed` names the model's seed in the steps' line).
    Frees the model.  Returns {phase: launch counts of the
    forward, phase + "_train": of the steps}."""
    groups = config.num_conv_pos_embedding_groups
    layers = config.num_layers
    robust = config.is_robust
    flash = fa.supports(config.hidden_size // config.num_heads, torch.bfloat16)
    require(config.hidden_size // groups == cg, f"{what}'s geometry")
    require(pc.supports(config.hidden_size, groups, torch.bfloat16, config.num_conv_pos_embeddings),
            f"the {config.hidden_size}-d card dispatch: pos-conv kernels at C/G = {cg}")
    front = {"conv01_robust": 1} if robust else {"groupnorm_stats": 1, "fused_conv01": 1}
    per_forward = {**front, "pos_conv": 1}
    if flash:
        per_forward["flash_attention_fwd"] = layers
    evaluator = GreedyCTCEvaluator(model)
    require(evaluator.compute_dtype == torch.bfloat16 and evaluator.use_attention_mask == robust,
            f"{what} runs in bf16 on the card, with a sample mask in the robust family")
    rng = np.random.default_rng(seed)
    speech, lengths = _ragged_batch(rng, b, SAMPLES, 80000 if robust else SAMPLES)
    reset_counts()
    t = time.perf_counter()
    texts = evaluator.predict_batch(speech, lengths)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    launches = read_counts()
    expect_counts(f"one {what} forward", launches, per_forward)
    require(len(texts) == b, "predict_batch returned the wrong number of transcripts")

    dev = model.device
    x = torch.from_numpy(speech).to(dev)
    m = (torch.from_numpy((np.arange(SAMPLES)[None, :] < lengths[:, None]).astype(np.float32)).to(dev)
         if robust else None)
    frames = config.conv_output_length(SAMPLES)

    def forward():
        with torch.inference_mode():
            return model(x, m)

    logits = forward()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()), f"non-finite {what} logits on the card")
    require(logits.shape == (b, frames, config.vocab_size), f"logits {tuple(logits.shape)}")

    def timed_forwards(n):
        reps = []
        for _ in range(n):
            t = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t) * 1e3)
        return reps

    reps = timed_forwards(10)
    row0 = logits[0].float().cpu()
    del logits
    plain = {}
    mod, off = {"front_end": (cf, set(front)), "pos_conv": (pc, {"pos_conv"}),
                "attention": (fa, {"flash_attention_fwd"} if flash else set())}[plain_site]
    if off:
        # the same forwards with the site's kernels turned off, for the record
        before = read_counts()
        with supports_off(mod):
            plain_reps = timed_forwards(3)
        expect_counts(f"the plain {plain_site} forwards", counts_since(before),
                      {k: 3 * v for k, v in per_forward.items() if k not in off})
        plain = {f"ms_per_forward_plain_{plain_site}": statistics.median(plain_reps),
                 f"plain_{plain_site}_min_max": [min(plain_reps), max(plain_reps)]}
    profile = profile_device(forward, 2, "forward", top=10)
    # row 0 (full length) through the card's f32 path, every site plain (flash
    # turned off: its f32 instance would take heads of 64)
    before = read_counts()
    with torch.inference_mode(), supports_off(fa):
        want = wav2vec2_for_ctc_forward(model, config, x[:1],
                                        torch.ones(1, SAMPLES, device=dev) if robust else None,
                                        compute_dtype=torch.float32)[0]
    expect_counts("the f32 reference forward", counts_since(before), {})
    err, mean_err, scale, agree = logits_vs(row0, want)
    del x, m, want
    # the family's cell's bounds (base, 12 layers: 5% of the logit scale;
    # robust, 24: 10%; argmax >= 90%)
    tol = 0.10 if robust else 0.05
    require(err <= tol * scale and agree >= 0.9,
            f"{what} card bf16 vs card f32: max {err} (scale {scale}), argmax agree {agree}")
    emit({"phase": phase, **info, "batch": [b, SAMPLES], "lengths": lengths.tolist(),
          "launches_per_forward": per_forward, "predict_batch_s": batch_s,
          "ms_per_forward": statistics.median(reps), "ms_per_forward_min_max": [min(reps), max(reps)],
          "forward_reps": len(reps), **plain, "f32_reference": "the card's plain f32 path",
          "f32_max_abs_err": err, "f32_mean_abs_err": mean_err, "logit_scale": scale,
          "argmax_agree": agree, "f32_tol": tol, "card": smi})
    emit({"phase": phase + "_profile", "card": smi, **profile})

    if pos_records:  # the four pos-conv kernels at the phase's shapes
        gen = torch.Generator().manual_seed(8000 + cg)
        pcv = model.wav2vec2.encoder.pos_conv_embed.conv
        with torch.no_grad():
            kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g)
        bias = (0.1 * torch.randn(config.hidden_size, generator=gen)).to(dev)
        records.append(pos_conv_eval_record(kernel, bias, ROBUST_B, frames, f"pos_conv_cg{cg}",
                                            (phase,), gen))
        records.extend(pos_conv_train_records(kernel, bias, ROBUST_B, frames, f"_cg{cg}",
                                              (phase + "_train",), gen))
        del kernel, bias
        torch.cuda.empty_cache()

    # training: the recipe's regularisation; the robust family's mask and
    # length-aware CTC
    tconfig = config.replace(dropout=0.1)
    require(tconfig.apply_spec_augment, "the recipe's SpecAugment")
    tb = ROBUST_B
    batch = {"speech": speech[:tb], "labels": _labels(rng, tb, tconfig.vocab_size, 120)}
    if robust:
        batch["attention_mask"] = (np.arange(SAMPLES)[None, :] < lengths[:tb, None]).astype(np.int32)
    per_step = {**front, "pos_conv_train_fwd": 1, "pos_conv_dx": 1, "pos_conv_dw": 1, **CTC_STEP}
    if flash:
        per_step.update(flash_attention_fwd=layers * (2 if remat else 1), flash_attention_bwd=layers)
    kw = dict(with_attention_mask=robust, length_aware=robust, remat=remat)
    regs = "dropout 0.1, SpecAugment" + (", mask" if robust else "")
    train = train_phase(phase + "_train", f"{what} {regs}, remat {remat}, seed {weights_seed}", model,
                        tconfig, batch, per_step, steps, smi, **kw)
    # two stage-2 losses and gradients of one batch from one seed: bit-equal
    loss_fn = make_ctc_loss_fn(tconfig, division_factor=tb, **kw)
    grads, losses = [], []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, torch.Generator().manual_seed(7))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        model.zero_grad(set_to_none=True)
    require(grads[0].keys() == grads[1].keys() and all(torch.equal(grads[0][n], grads[1][n])
                                                       for n in grads[0]),
            f"two identical {what} stage-2 gradients differ")
    require(losses[0] == losses[1] and np.isfinite(losses[0]), f"{phase} stage-2 losses {losses}")
    emit({"phase": phase + "_grads", "reps": 2, "loss": losses[0], "tensors": len(grads[0]),
          "grads_bit_equal": True, "card": smi})
    del grads, model, evaluator
    torch.cuda.empty_cache()
    return {phase: launches, phase + "_train": train}


# the exported program, run in a process that imports the port's kernels alone
# -- phases 13i, 13j: the f32 path (`--compute_dtype float32`) -----------------

# the f32 paths: a family's forward and stage-2 step, (family, batch, config
# fields changed): 13i base and robust/large with heads of 64, 13j the
# robust/large widths at 8 heads of 128, base at 4 of 192, robust/large at 4
# of 256 (13d's and 13e's geometries)
F32_MODELS = {"base_f32": (Wav2Vec2Config, B, {}), "robust_f32": (RobustWav2Vec2Config, ROBUST_B, {})}
F32_WIDE_MODELS = {
    "robust_h128_f32": (RobustWav2Vec2Config, ROBUST_B, {"num_heads": H128_HEADS}),
    "base_h192_f32": (Wav2Vec2Config, B, {"num_heads": WIDE_HEADS}),
    "robust_h256_f32": (RobustWav2Vec2Config, ROBUST_B, {"num_heads": WIDE_HEADS}),
}
# the f32 flash kernels' checks: head dim -> (batch, heads, ragged key bias,
# the paths that run the instance, the scores' std).  The wide instances are
# checked on unit-scale inputs (scores of std 1), the inputs the 1e-3
# gradient bound is stated for: with dout and v N(0, 1) the gradients' scale
# grows with sqrt(D), and at std 2 the long regime's dq at D = 128 was 1.7e-3
# off at a scale of 35 (4.8e-5 of it).  Every head dim also runs the std-6
# case under the relative bound.
F32_KERNELS = {64: (B, 12, True, tuple(F32_MODELS), 2.0)}
F32_WIDE_KERNELS = {128: (ROBUST_B, H128_HEADS, True, ("robust_h128_f32",), 1.0),
                    192: (B, WIDE_HEADS, False, ("base_h192_f32",), 1.0),
                    256: (ROBUST_B, WIDE_HEADS, True, ("robust_h256_f32",), 1.0)}
# the wide f32 kernels' tile edges: 64-row blocks and 32-row tiles, each L =
# 1, tile - 1, tile, tile + 1 and 2 tile + 1, and a ragged multi-tile length
F32_WIDE_EDGES = (1, 31, 32, 33, 63, 64, 65, 129, 1249)
F32_TOL = 1e-4        # out and lse (the JAX package's own f32 flash tests)
F32_GRAD_TOL = 1e-3   # each gradient, absolute; and 1e-4 of its max |value|
F32_LOGITS_TOL = 4e-3  # the JAX parity tests' logits bound (tests/test_parity.py)
F32_PEAKY_L = 8192    # the std-6 case: its gradients grow with the scores' scale


def flash_f32_errors(q, kk, v, dout, kb, rate, seed, what, floor=0.0, relative=False):
    """The f32 flash forward and backward against their plain versions on
    the same inputs (TF32 off), each launched twice, bit-equal: out and lse
    within `F32_TOL`; each gradient within `F32_GRAD_TOL` and within 1e-4 of
    its max |value| (+ `floor`: at L = 1, ds = p (dp - delta) is the rounding
    of dp and delta, and dq, dk are ~1e-5).  With `relative` (scores of std
    6, whose outputs grow past unit scale) each of out, lse and the
    gradients is held within 1e-4 of its max |value| alone.  Returns (out
    err, lse err, {dq, dk, dv: [err, err / scale]}, out, lse)."""
    out, lse = fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=seed)
    again = fa.flash_attention_fwd(q, kk, v, kb, dropout_rate=rate, seed=seed)
    require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
            f"flash f32 {what}: two forward launches differ")
    pout, plse = fa.flash_attention_fwd_plain(q, kk, v, kb, dropout_rate=rate, seed=seed)
    grads = fa.flash_attention_bwd(q, kk, v, kb, pout, plse, dout, dropout_rate=rate, seed=seed)
    again = fa.flash_attention_bwd(q, kk, v, kb, pout, plse, dout, dropout_rate=rate, seed=seed)
    require(all(torch.equal(a, c) for a, c in zip(grads, again)), f"flash f32 bwd {what}: two launches differ")
    pgrads = fa.flash_attention_bwd_plain(q, kk, v, kb, pout, plse, dout, dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    err, lse_err = errors(out, pout)[0], errors(lse, plse)[0]
    out_tol, lse_tol = ((1e-4 * pout.abs().max().item(), 1e-4 * plse.abs().max().item()) if relative
                        else (F32_TOL, F32_TOL))
    require(out.dtype == torch.float32 and err <= out_tol and lse_err <= lse_tol,
            f"flash f32 {what}: out {err}, lse {lse_err}")
    grad_tol = math.inf if relative else F32_GRAD_TOL
    by = {}
    for name, g, pg in zip(("dq", "dk", "dv"), grads, pgrads):
        gerr, scale = errors(g, pg)[0], pg.abs().max().item()
        require(g.dtype == torch.float32 and gerr <= grad_tol and gerr <= 1e-4 * scale + floor,
                f"flash f32 bwd {name} {what}: {gerr} (scale {scale})")
        by[name] = [gerr, gerr / scale if scale else 0.0]
    return err, lse_err, by, out, lse


def check_flash_f32_kernels(records, d: int, b: int, heads: int, ragged: bool, paths,
                            std: float) -> None:
    """The f32 flash kernels at head dim `d` (`csrc/flash_attention_f32.cu`
    at 64, `_f32_wide.cu` at 128-256) against their plain versions
    (`flash_f32_errors`: every launch twice, bit-equal) at the tile edges L
    = `FLASH_EDGES` (past 64 `F32_WIDE_EDGES`) on (2, 3, L, d), no bias and
    ragged, dropout 0 and 0.1;
    at (b, heads, 768, d), with a ragged bias where `ragged`, dropout 0 and
    0.1; at the long regime (1, heads, 5999, d) with dropout and a ragged
    bias (where JAX switches to its kv-blocked kernels); and at scores of
    std 6 on (1, 2, `F32_PEAKY_L`, d) with dropout, under the relative
    gradient bound alone; the other inputs N(0, 1), q scaled to scores of
    std `std`.  Timed at the first two shapes beside their bound
    (three TF32 products a product: `flash_peak`), the plain versions and
    SDPA in f32 with the same mask (a yardstick the port never calls).
    Appends the records `flash_attention_fwd_f32_d{d}` and
    `flash_attention_bwd_f32_d{d}`, run by `paths` and their stage-2 steps."""
    gen = torch.Generator().manual_seed(100 * d)
    rate, drop_seed = 0.1, 4321
    source = CSRC + ("flash_attention_f32.cu" if d == 64 else "flash_attention_f32_wide.cu")
    edges = FLASH_EDGES if d == 64 else F32_WIDE_EDGES
    edge = {"max_abs_err": 0.0, "lse_max_abs_err": 0.0, "bwd_max_rel_err": 0.0, "bwd_max_abs_err_at_L1": 0.0}
    for l in edges:
        q, kk, v, dout = _peaky(2, 3, l, d, gen, dtype=torch.float32, std=std)
        for bias in (None, _ragged_bias(2, l, gen)):
            for r in (0.0, rate):
                err, lse_err, by, _, _ = flash_f32_errors(
                    q, kk, v, dout, bias, r, drop_seed, f"d={d} L={l} bias={bias is not None} rate={r}",
                    floor=1e-4 if l == 1 else 0.0)
                edge["max_abs_err"] = max(edge["max_abs_err"], err)
                edge["lse_max_abs_err"] = max(edge["lse_max_abs_err"], lse_err)
                key, i = ("bwd_max_abs_err_at_L1", 0) if l == 1 else ("bwd_max_rel_err", 1)
                edge[key] = max([edge[key]] + [e[i] for e in by.values()])
    del q, kk, v, dout
    t = RobustWav2Vec2Config().conv_output_length(SAMPLES)
    q, kk, v, dout = _peaky(b, heads, t, d, gen, dtype=torch.float32, std=std)
    kb = _ragged_bias(b, t, gen) if ragged else None
    what = f"({b}, {heads}, {t}, {d})"
    err, lse_err, by0, _, _ = flash_f32_errors(q, kk, v, dout, kb, 0.0, drop_seed, what)
    derr, dlse_err, by, out, lse = flash_f32_errors(q, kk, v, dout, kb, rate, drop_seed, what)
    run_flash = lambda: fa.flash_attention_fwd(q, kk, v, kb)
    run_library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, v, attn_mask=None if kb is None else kb[:, None, None, :], scale=1.0)
    dev_ms, _ = device_kernels(run_flash)
    lib_dev_ms, lib_kernels = device_kernels(run_library)
    bms, bby = bound(4 * q.numel() * 4 + b * heads * t * 4 + (b * t * 4 if ragged else 0),
                     4 * b * heads * t * t * d, flash_peak(torch.float32))
    tols = dict(tol=F32_TOL, lse_tol=F32_TOL)
    fwd = dict(
        name=f"flash_attention_fwd_f32_d{d}", counter="flash_attention_fwd",
        paths=tuple(p for phase in paths for p in (phase, phase + "_train")),
        route="cuda", source=source, replaces=PALLAS + "flash_attention.py:224",
        also_replaces=[PALLAS + "flash_attention.py:516"], head_dim=d, dtype="float32",
        shape=[b, heads, t, d], score_std=std, ragged_bias=ragged, max_abs_err=err, lse_max_abs_err=lse_err, **tols,
        relaunch_bit_equal=True, ms=time_ms(run_flash, 30), device_ms=dev_ms,
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(q, kk, v, kb), 3, 1),
        bound_ms=bms, bound_by=bby, bound_peak="494.7 TFLOP/s dense TF32 / 3 (three TF32 products)",
        exp_bound_ms=exp_bound_ms(b * heads * t * t), library_ms=time_ms(run_library, 30),
        library="scaled_dot_product_attention in f32, the same additive mask",
        library_device_ms=lib_dev_ms, library_kernels=lib_kernels,
        edges=dict(shape=[2, 3, "L", d], checked_at_L=list(edges), **edge))
    fwd_rec, bwd_rec = flash_train_records(q, kk, v, dout, kb, out, lse, rate, drop_seed)
    fwd["dropout"] = dict(max_abs_err=derr, lse_max_abs_err=dlse_err, **tols, **fwd_rec)
    grad_tol = f"{F32_GRAD_TOL} abs and 1e-4 x each gradient's max |value|"
    bwd = dict(
        name=f"flash_attention_bwd_f32_d{d}", counter="flash_attention_bwd",
        paths=tuple(phase + "_train" for phase in paths),
        route="cuda", source=source, replaces=PALLAS + "flash_attention.py:285",
        also_replaces=[PALLAS + "flash_attention.py:595", PALLAS + "flash_attention.py:638"],
        head_dim=d, dtype="float32", max_abs_err=max(e[0] for e in by.values()), err_by_grad=by,
        no_dropout_err_by_grad=by0, tol=grad_tol, relaunch_bit_equal=True, **bwd_rec)
    del q, kk, v, dout, kb, out, lse
    torch.cuda.empty_cache()
    l = RobustWav2Vec2Config().conv_output_length(LONG_SAMPLES)
    q, kk, v, dout = _peaky(1, heads, l, d, gen, dtype=torch.float32, std=std)
    kb = _ragged_bias(1, l, gen)
    lerr, llse, lby, out, lse = flash_f32_errors(q, kk, v, dout, kb, rate, drop_seed, f"d={d} L={l}")
    fwd_rec, bwd_rec = flash_train_records(q, kk, v, dout, kb, out, lse, rate, drop_seed)
    fwd["long"] = dict(max_abs_err=lerr, lse_max_abs_err=llse, **tols, **fwd_rec)
    bwd["long"] = dict(max_abs_err=max(e[0] for e in lby.values()), err_by_grad=lby, tol=grad_tol,
                       **bwd_rec)
    del q, kk, v, dout, kb, out, lse
    q, kk, v, dout = _peaky(1, 2, F32_PEAKY_L, d, gen, dtype=torch.float32, std=6.0)
    kb = _ragged_bias(1, F32_PEAKY_L, gen)
    perr, plse_err, pby, _, _ = flash_f32_errors(q, kk, v, dout, kb, rate, drop_seed,
                                                 f"d={d} L={F32_PEAKY_L} std 6", relative=True)
    bwd["peaky"] = dict(shape=[1, 2, F32_PEAKY_L, d], score_std=6, dropout=rate, ragged_bias=True,
                        out_max_abs_err=perr, lse_max_abs_err=plse_err, err_by_grad=pby,
                        tol="1e-4 x the max |value| of out, lse and each gradient")
    del q, kk, v, dout, kb
    records.extend((fwd, bwd))
    torch.cuda.empty_cache()


@contextlib.contextmanager
def cudnn_defaults():
    """cuDNN's algorithm choice as PyTorch starts (not deterministic, no
    benchmarking), whatever an earlier phase's CLI set; restored after."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def f32_model_phase(phase: str, family, b: int, smi: str, fields: dict) -> dict:
    """`family(**fields)` at full width and depth, weights from seed 0, in
    f32 on the card (TF32 off, as `main` sets it): a batch of `b` x 246000
    (the robust family ragged, with its mask) through
    `GreedyCTCEvaluator.predict_batch` with its `compute_dtype` f32, one
    launch of the f32 flash forward a layer and no other kernel; ms a
    forward, and with the flash kernels off (the plain attention, what the
    card ran in f32 before); row 0's logits against the card's plain f32
    forward of that row (`F32_LOGITS_TOL`); then one stage-2 step of the
    first `ROBUST_B` rows with the recipe's dropout 0.1 and SpecAugment (and
    the mask), no remat: the flash forward and backward one a layer, the CTC
    pair 1 each; two identical stage-2 losses and gradients bit-equal under
    the training CLIs' setting (`training.deterministic_training`: the f32
    pos conv is cuDNN's; the tensors that differ under cuDNN's defaults are
    recorded).  Returns {phase: the forward's launches, phase + "_train":
    the step's}."""
    config = family(**fields)
    robust, layers = config.is_robust, config.num_layers
    require(config.dropout == 0.1 and config.apply_spec_augment
            and fa.supports(config.hidden_size // config.num_heads, torch.float32),
            f"{phase}: the recipe's regularisation, and heads the f32 flash kernels take")
    t = time.perf_counter()
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t
    evaluator = GreedyCTCEvaluator(model)
    evaluator.compute_dtype = torch.float32  # the card's default is bf16
    rng = np.random.default_rng(25)
    speech, lengths = _ragged_batch(rng, b, SAMPLES, 80000 if robust else SAMPLES)
    per_forward = {"flash_attention_fwd": layers}
    reset_counts()
    t = time.perf_counter()
    texts = evaluator.predict_batch(speech, lengths)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    launches = read_counts()
    expect_counts(f"one {phase} forward", launches, per_forward)
    require(len(texts) == b, "predict_batch returned the wrong number of transcripts")

    x = torch.from_numpy(speech).cuda()
    m = (torch.from_numpy((np.arange(SAMPLES)[None, :] < lengths[:, None]).astype(np.float32)).cuda()
         if robust else None)

    def forward():
        with torch.inference_mode():
            return wav2vec2_for_ctc_forward(model, config, x, m, compute_dtype=torch.float32)

    def timed(n):
        reps = []
        for _ in range(n):
            t = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t) * 1e3)
        return reps

    logits = forward()
    torch.cuda.synchronize()
    frames = config.conv_output_length(SAMPLES)
    require(logits.dtype == torch.float32 and logits.shape == (b, frames, config.vocab_size)
            and bool(torch.isfinite(logits).all()), f"{phase} logits {tuple(logits.shape)} {logits.dtype}")
    row0 = logits[0].cpu()
    del logits
    reps = timed(3)
    before = read_counts()
    with supports_off(fa):
        plain_reps = timed(2)
        with torch.inference_mode():
            want = wav2vec2_for_ctc_forward(model, config, x[:1],
                                            torch.ones(1, SAMPLES, device="cuda") if robust else None,
                                            compute_dtype=torch.float32)[0]
    expect_counts(f"the {phase} forwards with the plain attention", counts_since(before), {})
    err, mean_err, scale, agree = logits_vs(row0, want)
    require(err <= F32_LOGITS_TOL, f"{phase}: row 0 through the kernels vs the plain f32 forward: {err}")
    del x, m, want
    described = f"{family.__name__}({', '.join(f'{k}={v}' for k, v in fields.items())})"
    emit({"phase": phase, "config": f"{described} (full width and depth), f32, seed 0",
          "init_s": init_s, "batch": [b, SAMPLES], "lengths": lengths.tolist(),
          "launches_per_forward": per_forward, "predict_batch_s": batch_s,
          "ms_per_forward": statistics.median(reps), "ms_min_max": [min(reps), max(reps)],
          "ms_per_forward_plain_attention": statistics.median(plain_reps),
          "plain_attention_min_max": [min(plain_reps), max(plain_reps)],
          "row0_vs_plain_f32_max_abs_err": err, "row0_vs_plain_f32_mean_abs_err": mean_err,
          "logit_scale": scale, "argmax_agree": agree, "tol": F32_LOGITS_TOL, "card": smi})

    # one stage-2 step: the recipe's regularisation; the robust family's mask
    tb = ROBUST_B
    batch = {"speech": speech[:tb], "labels": _labels(rng, tb, config.vocab_size, 120)}
    if robust:
        batch["attention_mask"] = (np.arange(SAMPLES)[None, :] < lengths[:tb, None]).astype(np.int32)
    kw = dict(with_attention_mask=robust, length_aware=robust, remat=False, compute_dtype=torch.float32)
    per_step = {"flash_attention_fwd": layers, "flash_attention_bwd": layers, **CTC_STEP}
    set_trainable(model, STAGE2)
    st = create_train_state(model, create_optimizer(model, 1e-4))
    step = make_train_step(config, division_factor=tb, **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    st, metrics = step(st, batch, torch.Generator().manual_seed(0))
    loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    train = read_counts()
    expect_counts(f"the {phase} stage-2 step", train, per_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(np.isfinite(loss) and np.isfinite(norm), f"{phase} stage-2 loss {loss}, grad norm {norm}")
    # two stage-2 losses and gradients of one batch from one seed: bit-equal
    # under the CLIs' setting.  In f32 the pos conv is a plain grouped conv
    # (cuDNN), whose default backward algorithms may sum with atomics: the
    # tensors that differ under them are recorded.
    loss_fn = make_ctc_loss_fn(config, division_factor=tb, **kw)

    def two_grads():
        grads, losses = [], []
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            value = loss_fn(model, batch, torch.Generator().manual_seed(7))
            value.backward()
            losses.append(value.item())
            grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        model.zero_grad(set_to_none=True)
        differ = sorted(n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n]))
        return differ, losses, len(grads[0])

    with cudnn_defaults():
        differ_default, _, _ = two_grads()
        deterministic_training()
        differ, losses, tensors = two_grads()
    require(not differ and losses[0] == losses[1],
            f"two identical {phase} stage-2 gradients differ (deterministic_training): {differ}")
    emit({"phase": phase + "_train", "config": f"{described}, f32, dropout 0.1, SpecAugment"
          + (", mask" if robust else "") + ", no remat, seed 0", "batch": [tb, SAMPLES],
          "launches_per_stage2_step": per_step, "stage2_loss": loss, "stage2_grad_norm": norm,
          "first_step_ms": step_ms, "peak_memory_gb": peak_gb, "grad_tensors": tensors,
          "two_grads_bit_equal": "under training.deterministic_training",
          "differ_under_cudnn_defaults": differ_default, "card": smi})
    del st, model, evaluator
    torch.cuda.empty_cache()
    return {phase: launches, phase + "_train": train}


def tf32_truncation_check() -> dict:
    """`flash_attention.tf32_probe` (one SS and one RS TF32 wgmma against the
    identity): a 64 x 8 matrix of small integers comes back exact (the A
    operand where the wide f32 kernels put it, in shared memory and in
    registers), and f32 values with random low mantissa bits come back with
    their 13 low bits cleared through both: the kernels take an operand's
    raw bits as its TF32 hi on that (`csrc/flash_attention_f32_wide.cu`)."""
    x = torch.arange(512, dtype=torch.float32, device="cuda").reshape(64, 8)
    ys, yr = fa.tf32_probe(x)
    require(torch.equal(ys, x) and torch.equal(yr, x), "tf32 probe: the A operand is not where it was put")
    g = torch.Generator().manual_seed(27)
    bits = torch.randint(0, 2 ** 23, (64, 8), generator=g, dtype=torch.int32)
    xb = ((torch.randn(64, 8, generator=g).view(torch.int32) & ~0x7FFFFF) | bits).view(torch.float32).cuda()
    ys, yr = fa.tf32_probe(xb)
    trunc = (xb.view(torch.int32) & ~0x1FFF).view(torch.float32)
    require(torch.equal(ys, trunc) and torch.equal(yr, trunc),
            "tf32 probe: the card's wgmma does not read f32 by dropping 13 bits")
    return {"layout_exact": True, "reads_f32_truncated": True, "values": 2 * x.numel()}


def f32_phase(smi: str, records, kernels=F32_KERNELS, models=F32_MODELS, what="f32_kernels") -> dict:
    """Phases 13i (`F32_KERNELS`, `F32_MODELS`) and 13j (`F32_WIDE_KERNELS`,
    `F32_WIDE_MODELS`): `--compute_dtype float32`, where the JAX package runs
    its dtype-generic Pallas flash kernels on f32 inputs: past head dim 64 the
    TF32 probe first (`tf32_truncation_check`), the f32 flash kernels at each
    head dim (`check_flash_f32_kernels`), then each model through them
    (`f32_model_phase`).  Returns {path: launch counts}."""
    t = time.perf_counter()
    n = len(records)
    probe = tf32_truncation_check() if any(d > 64 for d in kernels) else None
    for d, (b, heads, ragged, paths, std) in kernels.items():
        check_flash_f32_kernels(records, d, b, heads, ragged, paths, std)
    emit({"phase": what, "checked": [r["name"] for r in records[n:]], "tf32_probe": probe,
          "seconds": time.perf_counter() - t, "card": smi})
    by_path = {}
    for phase, (family, b, fields) in models.items():
        by_path.update(f32_model_phase(phase, family, b, smi, fields))
    return by_path


EXPORT_CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch
from gsoc_wav2vec2_tpu_torch.export.torch_export import load_exported
from gsoc_wav2vec2_tpu_torch.ops.kernels import conv_frontend as cf, flash_attention as fa, pos_conv as pc
art, root = sys.argv[1], sys.argv[2]
counters = {"groupnorm_stats": cf.groupnorm_stats, "fused_conv01": cf.conv01,
            "conv01_robust": cf.conv01_robust, "pos_conv": pc.pos_conv,
            "flash_attention_fwd": fa.flash_attention_fwd}
t = time.perf_counter()
program, meta = load_exported(art)
run = program.module()
out = {"meta": meta, "load_s": time.perf_counter() - t, "runs": {},
       "ops": sorted({str(n.target) for n in program.graph.nodes if str(n.target).startswith("w2v2.")})}
for b in (16, 3):
    x = torch.from_numpy(np.load(f"{root}/speech{b}.npy")).cuda()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    with torch.inference_mode():
        logits = run(x)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters.items()}
    torch.save(logits.cpu(), f"{root}/logits{b}.pt")
    reps = []
    for _ in range(20 if b == 16 else 0):
        t = time.perf_counter()
        with torch.inference_mode():
            run(x)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t) * 1e3)
    out["runs"][b] = {"launches": counts, "ms": reps}
out["port_modules"] = sorted(m for m in sys.modules if m.startswith("gsoc_wav2vec2_tpu_torch"))
print(json.dumps(out))
"""
ONNX_SAMPLES = 32000


def export_phase(smi: str) -> dict:
    """Phase 14: `cli.export` through its own `main` at base width and depth
    (seed 0): `--format torch_export` on the card (symbolic batch, 246000
    samples), the artifact run in a fresh process that imports the port's
    kernels alone, at B=16 and B=3, its launches a forward against a live
    forward's and its logits against the live module's; then `--format
    onnx` at 32000 samples, evaluated by the port's `onnx_numpy` on the host
    against the f32 CPU forward.  Returns {"export": launch counts}."""
    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)
    per_forward = base_forward_counts(config.num_layers)
    rng = np.random.default_rng(14)
    batches = {b: rng.standard_normal((b, SAMPLES)).astype(np.float32) for b in (16, 3)}
    with tempfile.TemporaryDirectory(prefix="w2v2_export_") as root:
        model_dir, art = os.path.join(root, "model"), os.path.join(root, "artifact")
        model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
        model.save_pretrained(model_dir)
        live = {}
        with torch.inference_mode():
            for b, speech in batches.items():
                np.save(os.path.join(root, f"speech{b}.npy"), speech)
                live[b] = model(torch.from_numpy(speech).cuda()).cpu()
            x = torch.from_numpy(batches[16]).cuda()
            reps = []
            for _ in range(20):
                t = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t) * 1e3)
            del x
        live_ms = statistics.median(reps)
        del model
        torch.cuda.empty_cache()

        t = time.perf_counter()
        export_cli.main(["--model_id", model_dir, "--saved_model_dir", art,
                         "--seqlen", str(SAMPLES), "--format", "torch_export"])
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, art, root], capture_output=True,
                              text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        child_s = time.perf_counter() - t
        require(proc.returncode == 0, f"the exported program's process failed: {proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        require(child["meta"]["batch_size"] is None and child["meta"]["device"] == "cuda",
                f"artifact meta {child['meta']}")
        require(not any(m.startswith("gsoc_wav2vec2_tpu_torch.models") for m in child["port_modules"]),
                f"the program's process loaded model code: {child['port_modules']}")
        require(set(child["ops"]) == {"w2v2.fused_conv01.default", "w2v2.pos_conv.default",
                                      "w2v2.flash_attention_fwd.default"},
                f"the program's kernel operators: {child['ops']}")
        launches = {k: 0 for k in KERNELS}
        checks = {}
        for b, speech in batches.items():
            run = child["runs"][str(b)]
            got = {k: run["launches"].get(k, 0) for k in KERNELS}
            expect_counts(f"one forward of the exported program at B={b}", got, per_forward)
            for k, v in got.items():
                launches[k] += v
            logits = torch.load(os.path.join(root, f"logits{b}.pt"))
            require(logits.shape == live[b].shape, f"artifact logits {tuple(logits.shape)}")
            equal = torch.equal(logits, live[b])
            err, mean_err, scale, agree = logits_vs(logits[0], live[b][0])
            if not equal:  # the base cell's bound
                require(err <= 0.05 * scale and agree >= 0.9,
                        f"artifact B={b} vs live: max {err} (scale {scale}), argmax agree {agree}")
            checks[b] = {"bit_equal": equal, "max_abs_err": err, "mean_abs_err": mean_err,
                         "logit_scale": scale, "argmax_agree": agree}
        art_ms = child["runs"]["16"]["ms"]

        # ONNX at 32000 samples: evaluated on the host against the f32 CPU forward
        onnx_dir = os.path.join(root, "onnx")
        t = time.perf_counter()
        onnx_path = export_cli.main(["--model_id", model_dir, "--saved_model_dir", onnx_dir,
                                     "--seqlen", str(ONNX_SAMPLES), "--format", "onnx"])
        onnx_export_s = time.perf_counter() - t
        onnx_mb = os.path.getsize(onnx_path) / 2**20
        speech = np.random.default_rng(15).standard_normal((1, ONNX_SAMPLES)).astype(np.float32)
        t = time.perf_counter()
        (onnx_logits,) = OnnxModel(onnx_path).run({"speech": speech})
        onnx_eval_s = time.perf_counter() - t
        cpu_model = Wav2Vec2ForCTC.from_pretrained(model_dir, device="cpu")
        with torch.inference_mode():
            want = cpu_model(torch.from_numpy(speech)).numpy()
        del cpu_model
    onnx_err = float(np.abs(onnx_logits - want).max())
    require(onnx_logits.shape == want.shape and onnx_err <= 1e-3,
            f"ONNX at full depth vs the f32 forward: {onnx_err} (tol 1e-3), {onnx_logits.shape}")
    emit({"phase": "export", "config": "base (768-d, 12 layers, 12 heads) random seed 0",
          "format": "torch_export", "seqlen": SAMPLES, "symbolic_batch": True,
          "export_s": export_s, "child_s": child_s, "load_s": child["load_s"],
          "ops": child["ops"], "launches_per_forward": per_forward, "checks": checks,
          "artifact_ms_per_forward": statistics.median(art_ms),
          "artifact_ms_min_max": [min(art_ms), max(art_ms)], "live_ms_per_forward": live_ms,
          "live_ms_min_max": [min(reps), max(reps)], "forward_reps": len(reps),
          "onnx": {"seqlen": ONNX_SAMPLES, "export_s": onnx_export_s, "mb": onnx_mb,
                   "numpy_eval_s": onnx_eval_s, "max_abs_err": onnx_err, "tol": 1e-3},
          "card": smi})
    return {"export": launches}


PROFILED_KERNELS = ("conv01_kernel", "groupnorm_stats_kernel", "pos_conv_kernel", "flash_fwd_kernel")


PROFILING_ROUNDS = 11  # phase 15's turns of (synchronised median, chained host clock, timeit + its span)
PROFILING_REPS = 20   # calls a reading: `timeit`'s default `iters`


def _host_median_ms(forward, reps: int = PROFILING_REPS) -> float:
    """Phase 4's method: the median host-clock ms of `reps` calls, each
    ending in `torch.cuda.synchronize()`."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _chained_host_ms(forward, reps: int = PROFILING_REPS) -> float:
    """The host-clock ms of `reps` calls back to back, from an idle card to
    one synchronize after the last, over `reps`: what `timeit` computes,
    taken without it."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        forward()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def _timeit_and_span(forward) -> tuple[float, float]:
    """`profiling.timeit(forward)` at its defaults, in ms a call, and the
    card's ms a call over the same timed calls: CUDA events recorded before
    the first timed call (after the warmup calls) and after the last."""
    params = inspect.signature(profiling.timeit).parameters
    warmup, iters = params["warmup"].default, params["iters"].default
    calls, events = [0], []

    def counted():
        i = calls[0]
        calls[0] += 1
        if i == warmup:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        out = forward()
        if i == warmup + iters - 1:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        return out

    host_ms = profiling.timeit(counted) * 1e3
    require(calls[0] == warmup + iters and len(events) == 2,
            f"timeit made {calls[0]} calls, not {warmup} + {iters}")
    events[1].synchronize()
    return host_ms, events[0].elapsed_time(events[1]) / iters


def profiling_phase(smi: str, main_ms: float) -> None:
    """Phase 15: `utils.profiling` on the base forward (B=16 x 246000, seed
    0).  First `timeit` at its defaults (3 warmup calls, `PROFILING_REPS`
    timed back to back) against the card's own time for the same timed
    calls (`_timeit_and_span`), over `PROFILING_ROUNDS` rounds: the median
    of the rounds' relative differences must lie within the 3.5% spread
    between calls recorded in PERF.md section 2.  Both clocks read one
    interval, so a forward that the machine slows slows both alike (in one
    run on a card held at 1980 MHz, readings of this forward ran 11.9 to
    15.6 ms, a whole reading at a time, each within 0.1% of the card's span
    of it: PERF.md section 6); a `timeit` that timed its
    warmup calls, divided by another count or returned before the card had
    finished would miss them.  By turns with it, for the record: the like
    method without `timeit`, the host-clock ms of `PROFILING_REPS` forwards
    back to back ended by one synchronize, over their count (the chained
    clock first in even rounds), and phase 4's method (the median of
    synchronised calls, each of which drains the card; it read -3.0% to
    +4.1% against a chain, PERF.md section 6), beside phase 4's median,
    taken minutes earlier.  The turns come before the trace: after a trace
    the synchronised calls ran 3-15% slower.  Then `trace` around one
    forward inside `annotate("w2v2_forward")`, after an unannotated one;
    the kernels that ran in the region must include the four inference
    kernels."""
    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, SAMPLES)).astype(np.float32)).cuda()

    def forward():
        with torch.inference_mode():
            return model(x)

    forward()
    synced, chained, pairs = [], [], []
    for i in range(PROFILING_ROUNDS):
        synced.append(_host_median_ms(forward))
        # the chained clock and timeit swap places from round to round
        if i % 2:
            pairs.append(_timeit_and_span(forward))
            chained.append(_chained_host_ms(forward))
        else:
            chained.append(_chained_host_ms(forward))
            pairs.append(_timeit_and_span(forward))
    timed, spans = [t for t, _ in pairs], [d for _, d in pairs]
    rel = statistics.median(t / d - 1.0 for t, d in zip(timed, spans))
    chained_ms, timeit_ms = statistics.median(chained), statistics.median(timed)
    with tempfile.TemporaryDirectory(prefix="w2v2_trace_") as log_dir:
        with profiling.trace(log_dir):
            # late in a full run of this script a trace lost its first ~35
            # kernel records (up to the forward's first cuDNN convolution; 20 ms
            # of device sleep in front of them did not help), where a fresh
            # process kept them all: an unannotated forward takes that loss, and
            # the annotated one starts once it has finished
            forward()
            torch.cuda.synchronize()
            with profiling.annotate("w2v2_forward"):
                forward()
        path = os.path.join(log_dir, profiling.TRACE_NAME)
        trace_mb = os.path.getsize(path) / 2**20
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["name"]) for e in events if e.get("cat") == "kernel")
    starts = [e["ts"] for e in events if e.get("name") == "w2v2_forward"]
    # the annotated forward's kernels: those that ran after its region began
    inside = [n for ts, n in kernels if starts and ts >= min(starts)]
    found = {k: any(k in n for n in inside) for k in PROFILED_KERNELS}
    found["w2v2_forward"] = bool(starts)
    emit({"phase": "profiling", "trace_events": len(events), "trace_mb": trace_mb, "found": found,
          "kernel_events": len(kernels), "kernels_in_region": len(inside),
          "first_kernels": [n[:60] for _, n in kernels[:4]],
          "timeit_ms": timeit_ms, "device_span_ms": statistics.median(spans), "rounds": PROFILING_ROUNDS,
          "timeit_ms_by_round": timed, "device_span_ms_by_round": spans,
          "rel_diff": rel, "tol": 0.035,
          "order": "chained first in even rounds, timeit first in odd ones",
          "chained_host_ms": chained_ms, "chained_host_ms_by_round": chained,
          "chained_rel_diff_for_the_record": statistics.median(
              t / c - 1.0 for t, c in zip(timed, chained)),
          "synced_median_ms_by_round": synced,
          "synced_rel_diff_for_the_record": statistics.median(
              t / h - 1.0 for t, h in zip(timed, synced)),
          "main_median_ms": main_ms,
          "main_rel_diff_for_the_record": timeit_ms / main_ms - 1.0, "card": smi})
    require(all(found.values()), f"the trace lacks {[k for k, v in found.items() if not v]}")
    require(abs(rel) <= 0.035, f"timeit {timed} ms against the card's span of the same calls, {spans} ms")
    del model, x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 16. dist: data and tensor parallelism as two ranks on the one card
# ---------------------------------------------------------------------------

DIST_RANKS = 2
# the wrappers phase 16's ranks launch: rows 1, 2, 4-9, 13 and 14 of the table
DIST_KERNELS = ("groupnorm_stats", "fused_conv01", "pos_conv", "pos_conv_train_fwd", "pos_conv_dx",
                "pos_conv_dw", "flash_attention_fwd", "flash_attention_bwd", "scatter_rows_add",
                "ctc_loss_fwd", "ctc_loss_bwd")
DIST_RANK_TIMEOUT_S = 300   # each rank's process
DIST_GROUP_TIMEOUT_S = 120  # init_process_group and every collective: a dead peer fails its rank
DIST_TP_B = 16              # (b): one row-parallel activation is (16, 768, 768)
DIST_PRETRAIN_B = 8         # (c): rows a rank, 4 updates on its 32-utterance shard
DIST_EVAL_N = 17            # (d): 9 records on rank 0 (2 batches of 8), 8 on rank 1 (1 + a dummy)
# the first update's loss and gradient norm on two ranks against one process
# on the same global batch, bf16 on the card: the two sum the gradients in
# another order (data 2) or split every product of the layers (model 2);
# stated in PERF.md before the run that reads them
DIST_BOUNDS = {"loss_rel": 1e-3, "grad_norm_rel": 5e-3}


@contextlib.contextmanager
def _no_attention_dropout():
    """Attention-prob dropout off, every other draw unchanged: the flash
    dropout seed of a rank is `seed + shard * 2**20` (JAX's sharded step),
    so only without it can two ranks equal one process on the card."""
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
def _gather_loss():
    """The pretraining loss in the `gather` formulation, whose backward is
    `scatter_rows_add` on each rank's rows (the CLI's "auto" picks `gram`)."""
    loss = pt.pretraining_loss

    def gathered(*a, **kw):
        return loss(*a, **kw, contrastive_impl="gather")

    pt.pretraining_loss = gathered
    try:
        yield
    finally:
        pt.pretraining_loss = loss


class _DistProbe:
    """In a rank (and in the one-process references): each update's
    launches, host ms (ending in a readback), loss and gradient norm, and the
    ms of the collectives of device tensors within it.  Each collective is
    timed from a synchronize before it to one after it, so the kernels
    queued before it are not counted; the host-side control values (flags,
    counts) are not device tensors and are not counted."""

    def __init__(self):
        self.updates = []
        self.coll_ms = 0.0
        self.coll_calls = 0
        self.coll_mb = 0.0

    def _timed(self, real, pick):
        def collective(*a, **kw):
            t = pick(a, kw)
            if not t.is_cuda:
                return real(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.coll_ms += (time.perf_counter() - t0) * 1e3
            self.coll_calls += 1
            self.coll_mb += t.numel() * t.element_size() / 1e6
            return out

        return collective

    def _counted(self, make):
        def make_step(*a, **kw):
            step = make(*a, **kw)

            def counted(*args):
                before, coll = read_counts(), self.coll_ms
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(*args)
                loss = float(metrics["loss"])
                ms = (time.perf_counter() - t) * 1e3
                self.updates.append({"counts": counts_since(before), "ms": ms,
                                     "collective_ms": self.coll_ms - coll, "loss": loss,
                                     "grad_norm": float(metrics["grad_norm"])})
                return state, metrics

            return counted

        return make_step

    def __enter__(self):
        import torch.distributed as dist

        self._saved = [(dist, "all_reduce", dist.all_reduce), (dist, "all_gather", dist.all_gather),
                       (train_cli, "make_train_step", train_cli.make_train_step),
                       (pretrain_cli, "make_pretrain_step", pretrain_cli.make_pretrain_step)]
        dist.all_reduce = self._timed(dist.all_reduce, lambda a, kw: a[0] if a else kw["tensor"])
        dist.all_gather = self._timed(dist.all_gather, lambda a, kw: a[1] if len(a) > 1 else kw["tensor"])
        train_cli.make_train_step = self._counted(train_cli.make_train_step)
        pretrain_cli.make_pretrain_step = self._counted(pretrain_cli.make_pretrain_step)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _recorded_transcripts(into: list):
    """Every (reference, transcript) pair the evaluator scores, in order
    (dummy batches of a rank that ran dry are not scored)."""
    cls = GreedyCTCEvaluator
    agg = cls._aggregate_wer

    def recording(self, refs, hyps):
        into.extend(zip(refs, hyps))
        return agg(self, refs, hyps)

    cls._aggregate_wer = recording
    try:
        yield
    finally:
        cls._aggregate_wer = agg


def dist_worker(spec: dict) -> int:
    """One rank of phase 16 or 17, in a fresh interpreter started by
    `_start_ranks`: joins the group (the backend by
    `multihost.backend_for`), runs the CLI of `spec["case"]` with
    `spec["argv"]` under `_DistProbe` (the server under `_ShardProbe`), and
    prints one JSON line of its backend, launches, updates and results."""
    from gsoc_wav2vec2_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = multihost.initialize(timeout_s=DIST_GROUP_TIMEOUT_S)
    _build.library()  # built by the parent's phase 2: loaded, not rebuilt
    out = {"rank": multihost.rank(), "world": multihost.world_size(), "backend": backend,
           "device": str(torch.cuda.current_device()), "case": spec["case"]}
    pairs: list = []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        probe = stack.enter_context(_DistProbe())
        if spec.get("no_attention_dropout"):
            stack.enter_context(_no_attention_dropout())
        if spec.get("gather_loss"):
            stack.enter_context(_gather_loss())
        t = time.perf_counter()
        if spec["case"] == "train":
            args = train_cli.parse_args(spec["argv"])
            train_cli.main(args)
            out["run_dir"] = args.ckpt_dir
        elif spec["case"] == "pretrain":
            args = pretrain_cli.parse_args(spec["argv"])
            pretrain_cli.main(args)
            out["ckpt_dir"] = args.ckpt_dir
        elif spec["case"] == "serve":
            shards = stack.enter_context(_ShardProbe())
            serve.main(spec["argv"])
            out.update(blocks=shards.blocks, dispatches=shards.dispatches,
                       collective_calls=shards.calls)
        else:
            stack.enter_context(_recorded_transcripts(pairs))
            out["report"] = evaluate_cli.main(spec["argv"])
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t
    out.setdefault("collective_calls", probe.coll_calls)
    out.update(counts=read_counts(), updates=probe.updates, pairs=pairs,
               collective_mb=probe.coll_mb, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    multihost.shutdown()
    print(json.dumps({"dist_worker": out}), flush=True)
    return 0


def _start_ranks(what: str, spec: dict, root: str, world: int = DIST_RANKS):
    """`world` fresh interpreters of this script (`--dist-worker`), the ranks
    of one group on the card: torchrun's environment with a port from a
    freshly bound socket, `LOCAL_WORLD_SIZE` = world (so they share cuda:0
    and the backend rule gives gloo) and `GLOO_SOCKET_IFNAME=lo` (gloo binds
    the loopback device and resolves no host name); each rank's stdout and
    stderr go to files.  Returns (processes, (stdout, stderr) paths, start
    time); on a failure to start, every rank started is stopped."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = os.path.abspath(__file__)
    procs, logs = [], []
    t = time.perf_counter()
    try:
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world), GLOO_SOCKET_IFNAME="lo")
            out_path = os.path.join(root, f"{what}-{rank}.out")
            err_path = os.path.join(root, f"{what}-{rank}.err")
            logs.append((out_path, err_path))
            with open(out_path, "w") as o, open(err_path, "w") as e:
                procs.append(subprocess.Popen(
                    [sys.executable, script, "--dist-worker", json.dumps(spec)],
                    cwd=os.path.dirname(script), env=env, stdout=o, stderr=e))
    except BaseException:
        _stop_ranks(procs)
        raise
    return procs, logs, t


def _stop_ranks(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _rank_tails(logs) -> list:
    """The last 40 lines of each rank's stderr."""
    return [open(err).read().splitlines()[-40:] for _, err in logs]


def _run_ranks(what: str, spec: dict, root: str, world: int = DIST_RANKS) -> list:
    """`_start_ranks`, then `_finish_ranks` with `DIST_RANK_TIMEOUT_S`.
    Returns each rank's report (rank order) and the wall seconds."""
    procs, logs, t = _start_ranks(what, spec, root, world)
    return _finish_ranks(what, procs, logs, t, time.monotonic() + DIST_RANK_TIMEOUT_S, world)


def _finish_ranks(what: str, procs, logs, t: float, deadline: float, world: int = DIST_RANKS):
    """Wait for every rank until `deadline` (monotonic seconds); on any
    failure every rank is stopped, a JSON line with the last 40 lines of each
    rank's stderr is printed, and it raises.  Returns each rank's report
    (rank order) and the wall seconds since `t`."""
    timed_out = []
    try:
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                timed_out.append(rank)
                p.kill()
                p.wait()
    finally:
        _stop_ranks(procs)
    seconds = time.perf_counter() - t
    reports = []
    for out_path, _ in logs:
        lines = [l for l in open(out_path).read().splitlines() if l.startswith('{"dist_worker"')]
        reports.append(json.loads(lines[-1])["dist_worker"] if lines else None)
    if timed_out or any(p.returncode != 0 for p in procs) or None in reports:
        emit({"phase": "dist", "case": what, "failed": True, "seconds": seconds,
              "returncodes": [p.returncode for p in procs], "timed_out": timed_out,
              "stderr_tails": _rank_tails(logs)})
        raise RuntimeError(f"dist {what}: a rank failed (returncodes "
                           f"{[p.returncode for p in procs]}, timed out {timed_out})")
    for r in reports:
        require(r["backend"] == "gloo" and r["world"] == world,
                f"dist {what}: rank {r['rank']} ran backend {r['backend']} in a world of {r['world']}")
    return reports, seconds


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _update_summary(updates: list) -> dict:
    """ms, collective ms and share of the updates after the first (the
    first of a process also warms its allocator and libraries)."""
    later = updates[1:] or updates
    ms = statistics.median(u["ms"] for u in later)
    coll = statistics.median(u["collective_ms"] for u in later)
    return {"ms_per_update": ms, "first_update_ms": updates[0]["ms"], "collective_ms": coll,
            "collective_share": coll / ms}


def _one_process_first_update(model_dir: str, args: TrainingArgs, batch: dict, reps: int = 2):
    """The CLI's first stage-2 update in this process on `batch` (the same
    model, generator seed, division factor, remat, dtype; attention dropout
    off): its loss and gradient norm, and the ms of each of `reps` updates."""
    config = Wav2Vec2ForCTC.from_pretrained(model_dir).config
    model = Wav2Vec2ForCTC.from_pretrained(model_dir)
    set_trainable(model, STAGE2)
    state = create_train_state(model, create_optimizer(model, args.stage2_lr1),
                               generator=torch.Generator().manual_seed(args.seed + 2))
    with _DistProbe() as probe, _no_attention_dropout():
        step = train_cli.make_train_step(config, division_factor=len(batch["speech"]),
                                         compute_dtype=train_cli._compute_dtype(args),
                                         remat=train_cli.remat_value(args))
        for _ in range(reps):
            state, _ = step(state, batch, state.generator)
    del model, state
    torch.cuda.empty_cache()
    return probe.updates


def _first_batch(args: TrainingArgs, shards, data: int) -> dict:
    """The first global batch of the CLI's stream as `data` ranks load it:
    each data rank's first batch, stacked in rank order."""
    from gsoc_wav2vec2_tpu_torch.parallel import Mesh

    parts = [next(iter(train_cli._loader(args, shards, None, Mesh(data, 1, r))(
        seed=args.seed, drop_remainder=True))) for r in range(data)]
    return {k: np.concatenate([p[k] for p in parts]) for k in ("speech", "labels", "attention_mask")}


def _check_whole_checkpoint(run_dir: str, config) -> None:
    """The run's files are one process's: `final/` loads onto the card with
    the model's own shapes, and the last stage-2 checkpoint holds whole
    tensors."""
    want = {k: v.shape for k, v in Wav2Vec2ForCTC(config, device="cpu").state_dict().items()}
    final = Wav2Vec2ForCTC.from_pretrained(os.path.join(run_dir, "final"))
    require(final.device.type == "cuda", f"{run_dir}/final did not load onto the card")
    require({k: v.shape for k, v in final.state_dict().items()} == want,
            f"{run_dir}/final does not load as the one-process model")
    raw = CheckpointManager(os.path.join(run_dir, "stage2")).restore_raw()
    require({k: v.shape for k, v in raw["model"].items()} == want,
            "the stage-2 checkpoint does not hold whole tensors")
    del final, raw
    torch.cuda.empty_cache()


def _dist_train_case(name: str, smi: str, root: str, model_dir: str, shards, per_device: int,
                     model_axis: int, per_step: dict) -> dict:
    """(a) and (b): `cli.train` stage 2 as two ranks; the first update held
    against one process on the same global batch; exact launches a rank."""
    config = Wav2Vec2Config()
    data = DIST_RANKS // model_axis
    flags = ["--model_id", model_dir, "--train_tfrecords", *shards, "--stage1_epochs", "0",
             "--stage2_epochs", "1", "--batch_size_per_device", str(per_device),
             "--audio_maxlen", str(SAMPLES), "--logging_steps", "1", "--model_axis",
             str(model_axis), "--ckpt_dir", os.path.join(root, f"ckpt_{name}"),
             "--log_dir", os.path.join(root, f"logs_{name}")]
    ranks, seconds = _run_ranks(name, {"case": "train", "argv": flags,
                                       "no_attention_dropout": True}, root)
    args = train_cli.parse_args(flags)
    global_batch = per_device * data
    updates = len(shards) * 32 // global_batch
    for r in ranks:
        require(len(r["updates"]) == updates, f"{name}: rank {r['rank']} made {len(r['updates'])} updates")
        for i, u in enumerate(r["updates"]):
            expect_counts(f"{name} rank {r['rank']} update {i}", u["counts"], per_step)
        expect_counts(f"{name} rank {r['rank']}", r["counts"],
                      {k: v * updates for k, v in per_step.items()})
        require(all(u["loss"] == ranks[0]["updates"][i]["loss"] and
                    u["grad_norm"] == ranks[0]["updates"][i]["grad_norm"]
                    for i, u in enumerate(r["updates"])), f"{name}: the ranks' global metrics differ")
        require(all(math.isfinite(u["loss"]) for u in r["updates"]), f"{name}: a loss is not finite")
    run_dir = ranks[0]["run_dir"]
    require(ranks[1]["run_dir"] == run_dir, f"{name}: the ranks disagree on the run directory")
    _check_whole_checkpoint(run_dir, config)
    one = _one_process_first_update(model_dir, args, _first_batch(args, shards, data))
    got, want = ranks[0]["updates"][0], one[0]
    rel = {"loss_rel": _rel(got["loss"], want["loss"]),
           "grad_norm_rel": _rel(got["grad_norm"], want["grad_norm"])}
    emit({"phase": "dist", "case": name, "ranks": DIST_RANKS, "mesh": [data, model_axis],
          "backend": ranks[0]["backend"], "global_batch": [global_batch, SAMPLES],
          "rows_a_rank": per_device, "heads_a_rank": config.num_heads // model_axis,
          "ffn_a_rank": config.intermediate_size // model_axis,
          "attention_dropout": "off in both (shard seeds differ from one process's)",
          "first_update": {"ranks": {k: got[k] for k in ("loss", "grad_norm")},
                           "one_process": {k: want[k] for k in ("loss", "grad_norm")}, **rel},
          "bounds": DIST_BOUNDS, "losses": [u["loss"] for u in ranks[0]["updates"]],
          "two_ranks": [_update_summary(r["updates"]) for r in ranks],
          "one_process": _update_summary(one),
          "collective_calls_a_rank": [r["collective_calls"] for r in ranks],
          "collective_mb_a_rank": [r["collective_mb"] for r in ranks],
          "peak_gb_a_rank": [r["peak_gb"] for r in ranks], "rank_run_s": [r["run_s"] for r in ranks],
          "wall_s": seconds, "launches_per_update": per_step,
          "launches_a_rank": [r["counts"] for r in ranks], "checkpoint_whole": True,
          "note": "two ranks share one card over gloo (collectives staged through the host): "
                  "overhead, not scaling", "card": smi})
    require(all(rel[k] <= DIST_BOUNDS[k] for k in rel), f"{name}: first update {rel} beyond {DIST_BOUNDS}")
    return [r["counts"] for r in ranks]


def _dist_pretrain_case(smi: str, root: str, shards) -> list:
    """(c): `cli.pretrain` as two ranks at data 2 with the `gather` loss:
    finite losses, `scatter_rows_add` on each rank every update; beside the
    same CLI in this process on the same global batch size."""
    config = Wav2Vec2PretrainingConfig()
    per_step = {**pretrain_step_counts(config.num_layers, remat=True), "scatter_rows_add": 1}

    config_dir = os.path.join(root, "pretrain_config")
    config.save_pretrained(config_dir)

    def flags(tag, per_device):
        return ["--config", os.path.join(config_dir, "config.json"),
                "--train_tfrecords", *shards, "--epochs", "1", "--batch_size_per_device",
                str(per_device), "--audio_maxlen", str(SAMPLES), "--warmup_steps", "2",
                "--logging_steps", "1", "--ckpt_dir", os.path.join(root, f"pretrain_{tag}"),
                "--log_dir", os.path.join(root, f"pretrain_logs_{tag}")]

    ranks, seconds = _run_ranks("pretrain", {"case": "pretrain", "gather_loss": True,
                                             "argv": flags("ranks", DIST_PRETRAIN_B)}, root)
    updates = 32 // DIST_PRETRAIN_B
    for r in ranks:
        require(len(r["updates"]) == updates, f"pretrain: rank {r['rank']} made {len(r['updates'])} updates")
        for i, u in enumerate(r["updates"]):
            expect_counts(f"pretrain rank {r['rank']} update {i}", u["counts"], per_step)
            require(math.isfinite(u["loss"]) and math.isfinite(u["grad_norm"]),
                    f"pretrain rank {r['rank']} update {i}: {u}")
        expect_counts(f"pretrain rank {r['rank']}", r["counts"],
                      {k: v * updates for k, v in per_step.items()})
    require(os.path.isdir(os.path.join(ranks[0]["ckpt_dir"], "for_ctc")), "pretrain: no for_ctc/")
    with _DistProbe() as probe, _gather_loss():
        pretrain_cli.main(pretrain_cli.parse_args(flags("one", DIST_PRETRAIN_B * DIST_RANKS)))
    torch.cuda.empty_cache()
    emit({"phase": "dist", "case": "pretrain", "ranks": DIST_RANKS, "mesh": [DIST_RANKS, 1],
          "backend": ranks[0]["backend"], "global_batch": [DIST_PRETRAIN_B * DIST_RANKS, SAMPLES],
          "rows_a_rank": DIST_PRETRAIN_B, "loss": "gather (scatter_rows_add on each rank's rows)",
          "losses": [u["loss"] for u in ranks[0]["updates"]],
          "grad_norms": [u["grad_norm"] for u in ranks[0]["updates"]],
          "one_process_losses": [u["loss"] for u in probe.updates],
          "two_ranks": [_update_summary(r["updates"]) for r in ranks],
          "one_process": _update_summary(probe.updates),
          "collective_calls_a_rank": [r["collective_calls"] for r in ranks],
          "peak_gb_a_rank": [r["peak_gb"] for r in ranks], "wall_s": seconds,
          "launches_per_update": per_step, "launches_a_rank": [r["counts"] for r in ranks],
          "note": "each rank's shard is one file of the corpus, one process reads both: the "
                  "losses are not the same batches'", "card": smi})
    return [r["counts"] for r in ranks]


def _dist_evaluate_case(smi: str, root: str, model_dir: str, val_shard: str, per_forward: dict) -> list:
    """(d): `cli.evaluate --sharded` as two ranks over DIST_EVAL_N records
    (rank 0 runs 2 batches, rank 1 one and a dummy): the transcripts and the
    WER of one process."""
    shard = os.path.join(root, "eval.tfrecord")
    with native_io.TFRecordWriter(shard) as w:
        for i, (audio, label) in enumerate(native_io.read_tfrecords(val_shard)):
            if i < DIST_EVAL_N:
                w.write(audio, label)
    argv = ["--model_dir", model_dir, "--tfrecords", shard, "--mode", "padded",
            "--batch_size", "8"]
    ranks, seconds = _run_ranks("evaluate", {"case": "evaluate", "argv": argv + ["--sharded"]}, root)
    one: list = []
    t = time.perf_counter()
    with _recorded_transcripts(one):
        want = evaluate_cli.main(argv)
    one_s = time.perf_counter() - t
    got = [tuple(p) for r in ranks for p in r["pairs"]]
    forwards = [r["counts"]["fused_conv01"] for r in ranks]
    emit({"phase": "dist", "case": "evaluate", "ranks": DIST_RANKS, "backend": ranks[0]["backend"],
          "records": DIST_EVAL_N, "records_a_rank": [len(r["pairs"]) for r in ranks],
          "forwards_a_rank": forwards, "wer": [r["report"]["wer"] for r in ranks],
          "one_process_wer": want["wer"], "num_samples": [r["report"]["num_samples"] for r in ranks],
          "transcripts_equal": sorted(got) == sorted(one),
          "rank_run_s": [r["run_s"] for r in ranks], "one_process_s": one_s, "wall_s": seconds,
          "launches_a_rank": [r["counts"] for r in ranks], "card": smi})
    require([len(r["pairs"]) for r in ranks] == [9, 8], "evaluate: the records did not split 9 / 8")
    for r in ranks:  # rank 1's one batch and one dummy: two forwards each
        expect_counts(f"evaluate rank {r['rank']}", r["counts"],
                      {k: v * 2 for k, v in per_forward.items()})
        require(r["report"]["wer"] == want["wer"] and r["report"]["num_samples"] == DIST_EVAL_N,
                f"evaluate rank {r['rank']}: {r['report']} against one process's {want}")
    require(sorted(got) == sorted(one), "evaluate: the two ranks' transcripts differ from one process's")
    return [r["counts"] for r in ranks]


def dist_phase(smi: str) -> dict:
    """Phase 16: the parallel paths as two ranks on the one card (fresh
    interpreters; gloo, since NCCL refuses two ranks on one device).
    Returns the ranks' launches, summed, as the `dist` path."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "dist_memory", "free_gb": free / 1e9, "total_gb": total / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9, "card": smi})
    t0 = time.perf_counter()
    config = Wav2Vec2Config()  # base, the recipe's dropout 0.1 and SpecAugment
    per_step = base_step_counts(config.num_layers, remat=True)  # cli.train's default "dots"
    counts = []
    with tempfile.TemporaryDirectory(prefix="w2v2_dist_") as root:
        model_dir = os.path.join(root, "model")
        Wav2Vec2ForCTC(config, device="cpu", generator=torch.Generator().manual_seed(0)).save_pretrained(model_dir)
        train_shards, val_shard, _, _ = write_corpus(root, config.vocab_size)
        counts += _dist_train_case("train_data2", smi, root, model_dir, train_shards,
                                   TRAIN_B // DIST_RANKS, 1, per_step)
        counts += _dist_train_case("train_model2", smi, root, model_dir, train_shards[:1],
                                   DIST_TP_B, DIST_RANKS, per_step)
        counts += _dist_pretrain_case(smi, root, train_shards)
        counts += _dist_evaluate_case(smi, root, model_dir, val_shard,
                                      base_forward_counts(config.num_layers))
    emit({"phase": "dist_done", "seconds": time.perf_counter() - t0, "card": smi})
    return {"dist": {k: sum(c[k] for c in counts) for k in KERNELS}}


def check_dist_kernels(records) -> None:
    """Phase 16's shapes that no earlier phase holds, each against its plain
    version at the earlier phases' tolerances, timed, under its record's
    "dist" key: a rank's flash forward and backward at tensor-parallel 6
    heads (16, 6, 768, 64) and at 16 rows a data rank (16, 12, 768, 64),
    dropout 0.1 under rank 1's shard seed; the pos conv's training kernels at
    16 rows; the CTC kernels at 16 x 768 frames.  The front end at 16 rows,
    the eval pos conv at 8 rows and `scatter_rows_add` on 8 rows of 768
    frames are phase 3's, 11's and 9's shapes."""
    gen = torch.Generator().manual_seed(1616)
    by_name = {r["name"]: r for r in records}
    config = Wav2Vec2Config()
    t = config.conv_output_length(SAMPLES)
    d = config.hidden_size // config.num_heads
    seed = 12345 + 2**20  # rank 1's shard (data 2 or model 2) of a call seeded 12345
    fwd, bwd = by_name["flash_attention_fwd"], by_name["flash_attention_bwd"]
    fwd["dist"], bwd["dist"] = [], []
    for heads in (config.num_heads // DIST_RANKS, config.num_heads):
        q, kk, v, dout = _peaky(DIST_TP_B, heads, t, d, gen)
        kb = _ragged_bias(DIST_TP_B, t, gen)
        err, out, lse, rel, gabs, gmean = flash_dropout_errors(q, kk, v, dout, kb, 0.1, seed,
                                                               f"dist H={heads}")
        f, b = flash_train_records(q, kk, v, dout, kb, out, lse, 0.1, seed)
        fwd["dist"].append(dict(max_abs_err=err[0], mean_abs_err=err[1], tol=0.04, seed=seed, **f))
        bwd["dist"].append(dict(max_abs_err=gabs, mean_abs_err=gmean, max_rel_err_by_grad=rel,
                                tol="0.01 x each gradient's max |value|", seed=seed, **b))
        del q, kk, v, dout, out, lse
    model = Wav2Vec2ForCTC(config, device="cuda", generator=torch.Generator().manual_seed(0))
    pcv = model.wav2vec2.encoder.pos_conv_embed.conv
    kernel = conv_ops.weight_norm_kernel(pcv.weight_v, pcv.weight_g).detach()
    bias = (0.1 * torch.randn(config.hidden_size, generator=gen)).cuda()
    del model
    for rec in pos_conv_train_records(kernel, bias, TRAIN_B // DIST_RANKS, t, "", (), gen):
        name = rec.pop("name")
        for key in ("counter", "paths", "route", "source", "replaces"):
            rec.pop(key)
        by_name[name]["dist"] = rec
    log_probs, labels, lengths = _ctc_case(gen, TRAIN_B // DIST_RANKS, CTC_T, config.vocab_size,
                                           4, True)
    check = ctc_errors(log_probs, labels, lengths, True, f"dist {TRAIN_B // DIST_RANKS} x {CTC_T}")
    _, states = ctck.ctc_loss_fwd(log_probs, labels, lengths)
    ones = torch.ones(len(lengths), device=log_probs.device)
    x = log_probs.clone().requires_grad_(True)
    plain_loss = ctck.ctc_loss_plain(x, labels, lengths).sum()
    xl = log_probs.clone().requires_grad_(True)
    library = lambda: torch.nn.functional.ctc_loss(  # noqa: E731
        xl.transpose(0, 1), labels, lengths, (labels != 0).sum(1), reduction="none",
        zero_infinity=True)
    lib_loss = library().sum()
    n_states, (fwd_bytes, bwd_bytes) = ctc_work(log_probs, labels, lengths)
    runs = {"fwd": (lambda: ctck.ctc_loss_fwd(log_probs, labels, lengths),
                    lambda: ctck.ctc_loss_plain(log_probs, labels, lengths), library,
                    fwd_bytes, 21 * n_states),
            "bwd": (lambda: ctck.ctc_loss_bwd(log_probs, labels, lengths, states, ones),
                    lambda: torch.autograd.grad(plain_loss, x, retain_graph=True),
                    lambda: torch.autograd.grad(lib_loss, xl, retain_graph=True),
                    bwd_bytes, 39 * n_states)}
    for which, (kern, plain, lib, nbytes, ops) in runs.items():
        bms, by = bound(nbytes, ops, PEAK_F32)
        by_name[f"ctc_loss_{which}"]["dist"] = dict(
            shape=list(log_probs.shape) + [labels.shape[1]], **check,
            max_abs_err=check["grad_max_abs_err"], ms=time_ms(kern, 20),
            plain_ms=time_ms(plain, 2, 1), library_ms=time_ms(lib, 20), bound_ms=bms, bound_by=by)
    del log_probs, states, x, plain_loss, xl, lib_loss
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# 17. serve_sharded: cli.serve --sharded as two ranks on the one card
# ---------------------------------------------------------------------------

SHARDED_CLIENTS, SHARDED_REQUESTS = 8, 16  # cut from phase 11's 64 to hold the script's time
SHARDED_BASELINE = 8                       # and its 1-client pass from 16
SERVE_SHARDED_KERNELS = ("groupnorm_stats", "fused_conv01", "pos_conv", "flash_attention_fwd")
SERVE_SHARDED_DEADLINE_S = 240  # each rank's process, from its start to its exit
SERVE_SHARDED_STOP_S = 60       # SIGTERM to the leader, to both ranks' exit
# a word's confidence (the mean probability of its frames) may move with the
# batch the rows ran in: 4 rows a rank against 8 in one process
CONFIDENCE_TOL = 0.02


class _ShardProbe:
    """In a rank of phase 17: each block of rows this rank ran (rows,
    samples, mode, host ms ending in the copy to the host, launches) and, on
    the leader, each dispatch (its wall-clock start, host ms, and the ms of
    its broadcasts and gathers: the gathers also wait for the follower's
    block).  Heartbeats are collectives outside any dispatch."""

    def __init__(self):
        self.blocks, self.dispatches = [], []
        self.coll_ms, self.coll_mb, self.calls = 0.0, 0.0, 0

    def __enter__(self):
        from gsoc_wav2vec2_tpu_torch.parallel import multihost

        ev = GreedyCTCEvaluator
        self._saved = [(ev, "_local_step", ev._local_step), (ev, "_lead_step", ev._lead_step),
                       (multihost, "broadcast_from_leader", multihost.broadcast_from_leader),
                       (multihost, "gather_to_leader", multihost.gather_to_leader)]
        local, lead = ev._local_step, ev._lead_step

        def local_step(self_, speech, mask, mode):
            before = read_counts()
            t = time.perf_counter()
            out = local(self_, speech, mask, mode)
            self.blocks.append({"rows": int(speech.shape[0]), "samples": int(speech.shape[1]),
                                "mode": mode, "ms": (time.perf_counter() - t) * 1e3,
                                "launches": counts_since(before)})
            return out

        def lead_step(self_, speech, mask, mode):
            coll, wall = self.coll_ms, time.time()
            t = time.perf_counter()
            out = lead(self_, speech, mask, mode)
            self.dispatches.append({"rows": int(speech.shape[0]), "samples": int(speech.shape[1]),
                                    "mode": mode, "start": wall,
                                    "ms": (time.perf_counter() - t) * 1e3,
                                    "collective_ms": self.coll_ms - coll})
            return out

        def timed(real):
            def collective(t):
                t0 = time.perf_counter()
                out = real(t)
                self.coll_ms += (time.perf_counter() - t0) * 1e3
                self.coll_mb += t.numel() * t.element_size() / 1e6
                self.calls += 1
                return out

            return collective

        ev._local_step, ev._lead_step = local_step, lead_step
        multihost.broadcast_from_leader = timed(multihost.broadcast_from_leader)
        multihost.gather_to_leader = timed(multihost.gather_to_leader)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def _leader_address(out_path: str, procs, deadline: float) -> str:
    """The leader's "serving on http://..." address, from its stdout file."""
    while time.monotonic() < deadline:
        with open(out_path) as f:
            for line in f:
                if line.startswith("serving on "):
                    return line.split("serving on ", 1)[1].strip()
        require(all(p.poll() is None for p in procs),
                f"a rank exited before the server started: {[p.poll() for p in procs]}")
        time.sleep(0.2)
    raise RuntimeError("the sharded server did not report its address in time")


class _Posts:
    """`serve_bench._post` recorded for a `with` block: each request's client
    ms, start and end (host clock and wall clock), body and reply."""

    def __enter__(self):
        self.posts, self._post = [], serve_bench._post

        def post(url, body, timeout_s):
            t, wall = time.perf_counter(), time.time()
            reply = self._post(url, body, timeout_s)
            end = time.perf_counter()
            self.posts.append({"client_ms": (end - t) * 1e3, "start": t, "end": end,
                               "wall_start": wall, "wall_end": time.time(), "body": body, **reply})
            return reply

        serve_bench._post = post
        return self

    def __exit__(self, *exc):
        serve_bench._post = self._post

    def take(self) -> list:
        posts, self.posts = self.posts, []
        return posts


def _words_equal(got: list, want: list) -> float:
    """Words equal but for their confidences; returns the largest confidence gap."""
    strip = lambda ws: [{k: v for k, v in w.items() if k != "confidence"} for w in ws]  # noqa: E731
    require(strip(got) == strip(want), f"words {got} != one process's {want}")
    return max((abs(a["confidence"] - b["confidence"]) for a, b in zip(got, want)), default=0.0)


def _batch_gap(model, buckets, max_batch: int, world: int) -> dict:
    """Per bucket, the same (max_batch, bucket) rows through one forward and
    through `world` forwards of max_batch / world rows (a rank's batch): the
    largest log-prob gap, frames whose argmax differs, rows whose greedy
    transcript differs."""
    ev = GreedyCTCEvaluator(model)
    rng = np.random.default_rng(17)
    out = {}
    for bucket in buckets:
        x = (0.3 * rng.standard_normal((max_batch, bucket))).astype(np.float32)
        whole, _ = ev._local_step(x, None, "logprobs")
        parts = np.concatenate([ev._local_step(p, None, "logprobs")[0]
                                for p in np.split(x, world)])
        ids_a, ids_b = whole.argmax(-1), parts.argmax(-1)
        texts = sum(ev.tokenizer.decode(a) != ev.tokenizer.decode(b) for a, b in zip(ids_a, ids_b))
        out[bucket] = {"max_abs_logprob_gap": float(np.abs(whole - parts).max()),
                       "bit_equal": bool(np.array_equal(whole, parts)),
                       "argmax_frames_differ": int((ids_a != ids_b).sum()),
                       "frames": int(ids_a.size), "transcripts_differ": int(texts)}
    return out


def serve_sharded_phase(smi: str, records, model_dir: str, one: dict) -> dict:
    """Phase 17: `cli.serve --sharded` as two ranks on the one card, serving
    phase 11's model (`model_dir`) with `cli.serve`'s defaults.  Its replies
    to `serve_bench`'s bodies (8 clients x 16, then 1 x 8), a timestamped
    request, an alignment and a stream must be phase 11's (`one`); every
    dispatch is one forward of each rank's block of rows, with exact
    launches.  A SIGTERM to the leader must stop both ranks with exit code 0.
    Returns the ranks' launches, summed, as the `serve_sharded` path."""
    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)
    per_forward = base_forward_counts(config.num_layers)
    args = serve.parse_args(["--model_dir", model_dir])
    buckets = [int(b) for b in args.buckets.split(",")]
    rows = args.max_batch // DIST_RANKS
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    model = Wav2Vec2ForCTC.from_pretrained(model_dir)
    check_serve_kernels(model, records, rows, [SAMPLES], path="serve_sharded")
    gap = _batch_gap(model, buckets, args.max_batch, DIST_RANKS)
    del model
    torch.cuda.empty_cache()
    payloads = serve_bench.make_payloads(serve_bench.DEFAULT_LENGTHS)
    processor = Wav2Vec2Processor(is_tokenizer=False)
    with tempfile.TemporaryDirectory(prefix="w2v2_serve_sharded_") as root:
        # the ranks joined their group with DIST_GROUP_TIMEOUT_S (`dist_worker`),
        # which the server keeps: a heartbeat every quarter of it
        argv = ["--model_dir", model_dir, "--port", "0", "--sharded"]
        procs, logs, t0 = _start_ranks("serve_sharded", {"case": "serve", "argv": argv}, root)
        deadline = time.monotonic() + SERVE_SHARDED_DEADLINE_S
        try:
            base = _leader_address(logs[0][0], procs, deadline)
            start_s = time.perf_counter() - t0
            with _Posts() as rec:
                load = serve_bench.run_load(base, payloads, SHARDED_CLIENTS, SHARDED_REQUESTS)
                load_posts = rec.take()
                baseline = serve_bench.run_load(base, payloads, 1, SHARDED_BASELINE, warmup=False)
                base_posts = rec.take()
            ts = _http(base, "/v1/transcribe?timestamps=1", one["timestamps"]["body"], "audio/wav")
            align = one["align"]
            aligned = _http(base, "/v1/align?transcript=" + urllib.parse.quote(align["text"]),
                            align["body"], "audio/wav")
            clip = np.random.default_rng(2).standard_normal(SERVE_STREAM_S * 16000).astype(np.float32)
            sid = _http(base, "/v1/stream", json.dumps({"normalize": "none"}).encode(),
                        "application/json")["session"]
            piece, partials = SERVE_PIECE_S * 16000, []
            for lo in range(0, len(clip), piece):
                partials.append(_http(base, f"/v1/stream/{sid}", clip[lo : lo + piece].tobytes(),
                                      "application/octet-stream")["partial"])
            final = _http(base, f"/v1/stream/{sid}/finish", b"", "application/json")
            with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
                health = json.loads(resp.read())
        except BaseException:
            _stop_ranks(procs)
            emit({"phase": "serve_sharded", "failed": True, "returncodes": [p.poll() for p in procs],
                  "stderr_tails": _rank_tails(logs)})
            raise
        t_stop = time.perf_counter()
        procs[0].send_signal(signal.SIGTERM)
        ranks, seconds = _finish_ranks("serve_sharded", procs, logs, t0,
                                       min(deadline, time.monotonic() + SERVE_SHARDED_STOP_S))
        stop_s = time.perf_counter() - t_stop

    # the replies are phase 11's one-process replies
    require(load["errors"] == 0 and baseline["errors"] == 0, f"load errors: {load} {baseline}")
    for p in load_posts + base_posts:
        require(p["transcription"] == one["served"][p["body"]],
                f"sharded {p['transcription']!r} != one process's {one['served'][p['body']]!r}")
    require(ts["transcription"] == one["timestamps"]["reply"]["transcription"], "timestamped transcript")
    conf_gap = _words_equal(ts["words"], one["timestamps"]["reply"]["words"])
    require(aligned["transcription"] == align["reply"]["transcription"], "aligned transcript")
    conf_gap = max(conf_gap, _words_equal(aligned["words"], align["reply"]["words"]))
    require(final["transcription"] == one["stream"]["final"]
            and partials == one["stream"]["partials"], "the stream differs from one process's")
    require(conf_gap <= CONFIDENCE_TOL, f"word confidences {conf_gap} off one process's")
    require(health["requests"] == len(load_posts) + len(base_posts) + 1 and health["aligns"] == 1
            and health["streams"] == 1, f"server stats {health}")

    # every dispatch one forward of each rank's block, with exact launches
    leader, follower = ranks
    require(len(leader["blocks"]) == len(follower["blocks"]) == len(leader["dispatches"]) > 0,
            "each dispatch is one block on each rank")
    for r in ranks:
        for i, b in enumerate(r["blocks"]):
            d = leader["dispatches"][i]
            want_rows = rows if d["rows"] == args.max_batch else -(-d["rows"] // DIST_RANKS)
            require(b["rows"] == want_rows and b["samples"] == d["samples"] and b["mode"] == d["mode"],
                    f"rank {r['rank']} block {i} {b} of dispatch {d}")
            expect_counts(f"serve_sharded rank {r['rank']} dispatch {i}", b["launches"], per_forward)
        expect_counts(f"serve_sharded rank {r['rank']}", r["counts"],
                      {k: v * len(r["blocks"]) for k, v in per_forward.items()})
    transcribe = [d for d in leader["dispatches"] if d["rows"] == args.max_batch]
    require(all(d["samples"] in buckets and d["mode"] == "scored" for d in transcribe)
            and len(transcribe) >= len(buckets), "the transcribe dispatches")

    # the load pass: the dispatches' collective share and the leader's idle share
    window = (min(p["wall_start"] for p in load_posts[len(payloads):]),
              max(p["wall_end"] for p in load_posts[len(payloads):]))
    busy = sum(max(0.0, min(d["start"] + d["ms"] / 1e3, window[1]) - max(d["start"], window[0]))
               for d in leader["dispatches"])
    in_load = [d for d in leader["dispatches"] if window[0] <= d["start"] <= window[1]]
    coll = [d["collective_ms"] for d in in_load]
    emit({"phase": "serve_sharded", "config": "base (768-d, 12 layers) random seed 0, phase 11's model",
          "ranks": DIST_RANKS, "backend": leader["backend"], "buckets": buckets,
          "max_batch": args.max_batch, "rows_a_rank": rows, "window_ms": args.batch_window_ms,
          "ranks_start_s": start_s, "stop_s": stop_s, "returncodes": [0, 0],
          "load": {**_latency(load_posts[len(payloads):]), "clients": SHARDED_CLIENTS,
                   "serve_bench": load},
          "baseline": {**_latency(base_posts), "clients": 1, "serve_bench": baseline},
          "dispatches": len(leader["dispatches"]), "load_dispatches": len(in_load),
          "dispatch_ms_median": statistics.median(d["ms"] for d in in_load),
          "collective_ms_median": statistics.median(coll),
          "collective_share_median": statistics.median(d["collective_ms"] / d["ms"] for d in in_load),
          "leader_block_ms_median": statistics.median(
              b["ms"] for b, d in zip(leader["blocks"], leader["dispatches"]) if d in in_load),
          "leader_idle_share": 1.0 - busy / (window[1] - window[0]),
          "collective_calls_a_rank": [r["collective_calls"] for r in ranks],
          "launches_per_dispatch": per_forward, "launches_a_rank": [r["counts"] for r in ranks],
          "peak_gb_a_rank": [r["peak_gb"] for r in ranks],
          "replies_equal_one_process": True, "word_confidence_max_gap": conf_gap,
          "batch_gap_8_vs_2x4": gap, "phase_s": time.perf_counter() - t_phase, "wall_s": seconds,
          "note": "two ranks share one card over gloo (each batch and its outputs through the "
                  "host): overhead, not scaling", "card": smi})
    return {k: sum(r["counts"][k] for r in ranks) for k in KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    walls, clock = {}, [time.perf_counter()]

    def lap(finished: str) -> None:
        """Wall seconds since the last lap, under the phase just finished."""
        now = time.perf_counter()
        walls[finished] = now - clock[0]
        clock[0] = now

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "card", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    lap("card")
    # 2. build: the CUDA kernels and, beside them, the data plane's codec (g++)
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        codec = pool.submit(native_io.build)
        _build.library()
        kernels_s = time.perf_counter() - t_build
        codec.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t_build, "kernels_s": kernels_s})

    # the model of phase 4 (its weights also feed phase 3)
    config = Wav2Vec2Config(dropout=0.0, apply_spec_augment=False)  # base: 768-d, 12 layers
    model = Wav2Vec2ForCTC(config, device=dev, generator=torch.Generator().manual_seed(0))

    lap("build")
    # 3. kernels (those of the robust/large shapes come with its model, in phase 7)
    records = check_kernels(model)
    check_train_kernels(model, records)
    check_long_kernels(model, records)
    check_eval_kernels_at(model, records, TRAIN_B)  # the cli phase's batch
    check_ctc_kernels(records)
    emit({"phase": "kernels", "checked": [r["name"] for r in records], "card": smi})

    lap("kernels")
    # 4. main path
    per_forward = base_forward_counts(config.num_layers)
    evaluator = GreedyCTCEvaluator(model)
    require(evaluator.compute_dtype == torch.bfloat16, "the card path must run in bf16")
    rng = np.random.default_rng(0)
    speech = rng.standard_normal((B, SAMPLES)).astype(np.float32)
    utterances = [rng.standard_normal(n).astype(np.float32) for n in (SAMPLES, 160000, 83000)]
    clip = rng.standard_normal(40 * 16000).astype(np.float32)

    reset_counts()
    t_main = time.perf_counter()
    texts = evaluator.predict_batch(speech)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t_main
    first = read_counts()
    padded = np.zeros((3, SAMPLES), np.float32)
    for i, u in enumerate(utterances):
        padded[i, : len(u)] = u
    t_req = time.perf_counter()
    answers = evaluator.predict_batch(padded, np.array([len(u) for u in utterances]))
    req_s = time.perf_counter() - t_req
    t_long = time.perf_counter()
    long_text = evaluator.transcribe_long(clip)
    long_s = time.perf_counter() - t_long
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts("one forward", first, per_forward)
    n_chunks = len(plan_chunks(len(clip), 246000, 16000, config.conv_output_length, 320))
    forwards = 2 + n_chunks
    expect_counts("the main path", launches, {k: v * forwards for k, v in per_forward.items()})
    require(len(texts) == B and len(answers) == 3 and isinstance(long_text, str),
            "the evaluator returned the wrong number of transcripts")
    by_path = {"inference": launches}

    # steady-state forward time of the B=16 batch (device-synchronised host clock)
    x = torch.from_numpy(speech).to(dev)
    with torch.inference_mode():
        logits = wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)
        again = wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        # no float atomics on the path (groupnorm_stats sums its partials in a
        # fixed order): a second forward of the batch gives the same bits
        require(torch.equal(logits, again), "two forwards of one batch differ on the card")
        del again
        require(bool(torch.isfinite(logits).all()), "non-finite logits on the card")
        require(logits.shape == (B, config.conv_output_length(SAMPLES), config.vocab_size),
                f"logits shape {tuple(logits.shape)}")
        reps = []
        for _ in range(20):
            t = time.perf_counter()
            wav2vec2_for_ctc_forward(model, config, x, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t)
    fwd_ms = statistics.median(reps) * 1e3
    row0 = logits[0].float().cpu()
    profile = profile_forward(model, config, x)
    del x, logits

    # the card's bf16 logits against the model's f32 CPU path, row 0
    cpu_model = model.to("cpu")
    with torch.inference_mode():
        ref = wav2vec2_for_ctc_forward(
            cpu_model, config, torch.from_numpy(speech[:1]), compute_dtype=torch.float32)[0]
    err, mean_err, scale, agree = logits_vs(row0, ref)
    # bf16 through 12 layers against f32: 5% of the logit scale, and the
    # greedy path (argmax per frame) on >= 90% of frames
    require(err <= 0.05 * scale and agree >= 0.9,
            f"card bf16 vs CPU f32: max {err} (scale {scale}), argmax agree {agree}")
    audio_s = B * SAMPLES / 16000
    emit({"phase": "main", "config": "base (768-d, 12 layers, 12 heads) random seed 0",
          "batch": [B, SAMPLES], "launches_per_forward": per_forward, "forwards": forwards,
          "ms_per_forward": fwd_ms, "ms_per_forward_min_max": [min(reps) * 1e3, max(reps) * 1e3],
          "forward_reps": len(reps), "audio_s_per_s": audio_s / (fwd_ms / 1e3),
          "predict_batch_s": batch_s, "requests_s": req_s, "transcribe_long_s": long_s,
          "long_chunks": n_chunks, "two_forwards_bit_equal": True, "cpu_f32_max_abs_err": err,
          "cpu_f32_mean_abs_err": mean_err, "logit_scale": scale,
          "argmax_agree": agree, "card": smi})
    emit({"phase": "profile", "card": smi, **profile})
    del model, cpu_model
    tiny_phase(smi)

    lap("main")
    # 6. training (base)
    by_path["train"] = base_train_phase(smi)
    layer_norm_cost(smi)
    lap("train")
    # 7. the robust/large family: its kernels at its shapes, then its paths.  The
    # model comes only now, so that the base phases' peak memory is theirs alone
    robust_model = Wav2Vec2ForCTC(
        RobustWav2Vec2Config(dropout=0.0, apply_spec_augment=False), device=dev,
        generator=torch.Generator().manual_seed(0))
    n_base = len(records)
    check_robust_kernels(robust_model, records)
    emit({"phase": "robust_kernels", "checked": [r["name"] for r in records[n_base:]], "card": smi})
    by_path.update(robust_phases(robust_model, smi))
    del robust_model
    torch.cuda.empty_cache()
    lap("robust")
    # 8. long audio in one pass
    by_path.update(long_phases(smi))
    lap("long")
    # 9. pretraining: the scatter kernel at the recipe's shapes, then the paths
    check_scatter_kernels(records, smi)
    by_path.update(pretrain_phases(smi))
    lap("pretrain")
    # 10. the command-line path: weight files, the data plane, both stages, resume, evaluate
    by_path.update(cli_phase(smi))
    lap("cli")
    # 11. the HTTP server: batching, timestamps, a stream, alignment, beam search;
    # its model and replies serve again in phase 17
    serve_root = tempfile.TemporaryDirectory(prefix="w2v2_serve_")
    by_path["serve"], one_serve = serve_phase(smi, records, serve_root.name)
    lap("serve")
    # 12. rematerialisation: the three policies on fine-tuning and pretraining steps
    by_path["remat"] = remat_phase(smi)
    lap("remat")
    # 13. HuBERT-large from a raw HF snapshot
    by_path.update(hubert_phase(smi))
    lap("hubert")
    # 13b. the 1280-d family: HuBERT-xlarge from a raw HF snapshot, its kernels
    # at C/G = 80, inference and stage-2 steps
    by_path.update(xlarge_phase(smi, records))
    lap("xlarge")
    # 13c. XLS-R 2B's 1920-d: its kernels at C/G = 120, inference and stage-2 steps
    by_path.update(xls_r_2b_phase(smi, records))
    lap("xls_r_2b")
    # 13d. the robust/large widths at 8 heads of 128: the flash kernels' D = 128
    # instances, inference and stage-2 steps
    by_path.update(robust_h128_phase(smi, records))
    lap("robust_h128")
    # 13e. the flash kernels' D = 192 and 256 instances: base width at 4 heads
    # of 192, the robust/large widths at 4 of 256, inference and stage-2 steps
    by_path.update(wide_heads_phase(smi, records))
    lap("wide_heads")
    # 13f. the conv01 instances at every front-end width from 128 to 1024, then
    # base at a 384-wide front end and robust/large at a 1024-wide one
    by_path.update(conv_widths_phase(smi, records))
    lap("conv_widths")
    # 13g. the pos-conv instances at 32, 96, 112 and 128 channels a group, then
    # base and robust/large with their pos conv in 8 groups (96 and 128)
    by_path.update(pos_widths_phase(smi, records))
    lap("pos_widths")
    # 13h. the pos-conv instances at the odd multiples of 8 below 128 channels
    # a group, then base with its pos conv in 32 groups (24) and robust/large
    # in 128 (8)
    by_path.update(pos_widths_phase(smi, records, POS_ODD8_WIDTHS, POS_ODD8_MODELS, "pos_odd8"))
    lap("pos_odd8")
    # 13i. `--compute_dtype float32`: the f32 flash kernels at head dim 64, then
    # base and robust/large in f32 through them
    by_path.update(f32_phase(smi, records))
    lap("f32")
    # 13j. the f32 flash kernels at head dims 128, 192 and 256, then 13d's and
    # 13e's geometries in f32 through them
    by_path.update(f32_phase(smi, records, F32_WIDE_KERNELS, F32_WIDE_MODELS, "f32_wide_kernels"))
    lap("f32_wide")
    # 14. export: torch.export run in a process of its own, then ONNX
    by_path.update(export_phase(smi))
    lap("export")
    # 15. the profiling helpers on the base forward
    profiling_phase(smi, fwd_ms)
    lap("profiling")
    # 16. data and tensor parallelism: two ranks on the one card, each a fresh
    # interpreter; the kernels at the ranks' own shapes first
    check_dist_kernels(records)
    by_path.update(dist_phase(smi))
    dist_paths = {"cli", "pretrain_cli", "pretrain_gather"}
    for r in records:
        if by_path["dist"][r["counter"]] and dist_paths & set(r["paths"]):
            r["paths"] = tuple(r["paths"]) + ("dist",)
    ran = {r["counter"] for r in records if "dist" in r["paths"]}
    require(ran == set(DIST_KERNELS), f"the dist path's kernels: {sorted(ran)}")
    lap("dist")
    # 17. cli.serve --sharded: two ranks on the one card serve phase 11's model
    by_path["serve_sharded"] = serve_sharded_phase(smi, records, os.path.join(serve_root.name, "model"),
                                                   one_serve)
    serve_root.cleanup()
    for r in records:
        if by_path["serve_sharded"][r["counter"]] and "serve" in r["paths"]:
            r["paths"] = tuple(r["paths"]) + ("serve_sharded",)
    ran = {r["counter"] for r in records if "serve_sharded" in r["paths"]}
    require(ran == set(SERVE_SHARDED_KERNELS), f"the serve_sharded path's kernels: {sorted(ran)}")
    for r in records:
        counter, paths = r.pop("counter"), r.pop("paths")
        r["launches_by_path"] = {p: by_path[p][counter] for p in paths}
        r["launches"] = sum(r["launches_by_path"].values())
        require(r["launches"] > 0 and all(r["launches_by_path"].values()),
                f"{r['name']} was not launched on each of its paths: {r['launches_by_path']}")

    lap("serve_sharded")
    emit({"phase": "walls", "seconds": walls, "total_s": sum(walls.values())})
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":  # one rank of phase 16
        sys.exit(dist_worker(json.loads(sys.argv[2])))
    sys.exit(main())

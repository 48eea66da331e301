"""The port's parallel layer in one process, against the JAX package.

The tensor-parallel rules (`parallel/partition.py::param_specs`) name by
name against JAX's `param_specs`; the per-shard flash dropout (`seed + shard
* 2**20` on each shard's rows and heads) against JAX's
`shard_mapped_flash_attention` in interpret mode on (2, 1), (1, 2) and
(2, 2) CPU meshes (conftest gives 8 devices); the blocks of the global
dropout masks and SpecAugment draws that a rank takes; the mesh's rules and
errors.  Runs over several processes are in `test_torch_parallel_train.py`,
`_multihost.py` and `_cli.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils import tiny_config, tiny_pretraining_config

from gsoc_wav2vec2_tpu.models import modeling as jax_modeling
from gsoc_wav2vec2_tpu.models import pretraining as jax_pretraining
from gsoc_wav2vec2_tpu.ops.pallas import flash_attention as jax_fa
from gsoc_wav2vec2_tpu.parallel import make_mesh as jax_make_mesh
from gsoc_wav2vec2_tpu.parallel import param_specs as jax_param_specs
from gsoc_wav2vec2_tpu_torch.models import config as port_config
from gsoc_wav2vec2_tpu_torch.models import modeling
from gsoc_wav2vec2_tpu_torch.models import pretraining as port_pretraining
from gsoc_wav2vec2_tpu_torch.ops import attention, basic, specaugment
from gsoc_wav2vec2_tpu_torch.ops.kernels import flash_attention as flash
from gsoc_wav2vec2_tpu_torch.parallel import Mesh, batch_sharding, make_mesh, param_specs
from gsoc_wav2vec2_tpu_torch.parallel.mesh import global_rows, global_span
from gsoc_wav2vec2_tpu_torch.parallel.partition import shard_state_dict

torch.set_num_threads(2)


def _jax_specs_by_port_name(jax_params):
    """JAX's spec of each leaf under the port's dotted name, the layer-stack
    dimension dropped (the port keeps a `ModuleList`)."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jax_param_specs(jax_params), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = ".".join(str(k) for k in keys)
        entries = tuple(spec)
        if "layers" in keys:
            assert entries == () or entries[0] is None, (name, entries)
            entries = entries[1:]
        out[name] = entries
    return out


@pytest.mark.parametrize("family", ["ctc", "ctc_robust", "pretraining"])
def test_param_specs_match_jax_name_by_name(family):
    if family == "pretraining":
        cfg = tiny_pretraining_config()
        jp = jax_pretraining.init_wav2vec2_for_pretraining_params(jax.random.PRNGKey(0), cfg)
        model = port_pretraining.Wav2Vec2ForPreTraining(
            port_config.Wav2Vec2PretrainingConfig(**dataclasses.asdict(cfg)), device="cpu")
    else:
        robust = family == "ctc_robust"
        cfg = tiny_config(robust=robust)
        jp = jax_modeling.init_wav2vec2_for_ctc_params(jax.random.PRNGKey(0), cfg)
        cls = port_config.RobustWav2Vec2Config if robust else port_config.Wav2Vec2Config
        model = modeling.Wav2Vec2ForCTC(cls(**dataclasses.asdict(cfg)), device="cpu")
    want = _jax_specs_by_port_name(jp)
    got = param_specs(model)
    unstacked = {".".join(p for p in n.split(".") if not p.isdigit() or "conv_layers" in n): s
                 for n, s in got.items()}
    assert set(unstacked) == set(want)
    for name, spec in unstacked.items():
        # JAX writes a trailing None where the port writes nothing
        assert tuple(spec) + (None,) * (len(want[name]) - len(spec)) == want[name], name
    split = {n for n, s in got.items() if s}
    # a layer: q/k/v and intermediate_dense kernels and biases, out_proj and output_dense kernels
    assert len(split) == 10 * cfg.num_layers
    assert all(n.split(".")[-2] in {"q_proj", "k_proj", "v_proj", "intermediate_dense",
                                     "out_proj", "output_dense"} for n in split)


def test_shard_state_dict_splits_columns_rows_and_keeps_the_rest():
    model = modeling.Wav2Vec2ForCTC(port_config.Wav2Vec2Config(
        **dataclasses.asdict(tiny_config())), device="cpu")
    full = model.state_dict()
    parts = [shard_state_dict(full, Mesh(1, 2, r)) for r in range(2)]
    pre = "wav2vec2.encoder.layers.0."
    for name, dim in (("attention.q_proj.kernel", 1), ("attention.q_proj.bias", 0),
                      ("feed_forward.intermediate_dense.kernel", 1),
                      ("attention.out_proj.kernel", 0), ("feed_forward.output_dense.kernel", 0)):
        torch.testing.assert_close(torch.cat([p[pre + name] for p in parts], dim=dim),
                                   full[pre + name], rtol=0, atol=0)
        assert parts[0][pre + name].shape[dim] * 2 == full[pre + name].shape[dim]
    for name in ("attention.out_proj.bias", "feed_forward.output_dense.bias", "layer_norm.gamma"):
        assert parts[1][pre + name] is full[pre + name]
    with pytest.raises(ValueError, match="does not divide the model axis"):
        shard_state_dict(full, Mesh(1, 3, 0))


# -- the per-shard flash dropout against JAX's shard_map ---------------------


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_shard_seeds_match_jax_shard_mapped_flash_attention(data, model):
    """Each shard's output of JAX's `shard_mapped_flash_attention` (dropout
    0.1, interpret mode) equals the port's plain flash on that shard's rows
    and heads with seed + shard * 2**20, shard = d * model + m, and the kept
    bits are equal: with v the identity, out is the dropped probabilities."""
    b, h, l = 4, 4, 64
    rng = np.random.default_rng(data * 10 + model)
    q = rng.standard_normal((b, h, l, l)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, h, l, l)).astype(np.float32) * 0.3
    v = np.broadcast_to(np.eye(l, dtype=np.float32), (b, h, l, l)).copy()
    mask = np.ones((b, l), np.float32)
    mask[1, 50:] = 0.0
    bias = (1.0 - mask) * -10000.0
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    want = np.asarray(jax_fa.shard_mapped_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias)[:, None, None, :],
        mesh=mesh, data_axis="data", model_axis="model", dropout_rate=0.1, dropout_seed=4321,
        interpret=True))
    bl, hl = b // data, h // model
    for d in range(data):
        for m in range(model):
            rows, heads = slice(d * bl, (d + 1) * bl), slice(m * hl, (m + 1) * hl)
            seed = 4321 + (d * model + m) * 2**20
            got, _ = flash.flash_attention_fwd_plain(
                *(torch.from_numpy(t[rows, heads]) for t in (q, k, v)),
                torch.from_numpy(bias[rows]), dropout_rate=0.1, seed=seed)
            np.testing.assert_allclose(got.numpy(), want[rows, heads], atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(got.numpy() != 0, want[rows, heads] != 0)
            # the dropped share, over the keys no row masks
            assert 0.05 < float((got[..., :50] == 0).float().mean()) < 0.15


def test_mha_under_a_mesh_takes_the_shard_seed_on_its_rows():
    """Rank 1 of a (2, 1) mesh: its rows through `mha` equal the plain flash
    with seed + 1 * 2**20 (no collective runs with one model rank)."""
    h, heads, l = 64, 4, 20
    rng = np.random.default_rng(3)

    class P:
        pass

    params = P()
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        d = P()
        d.kernel = torch.from_numpy(rng.standard_normal((h, h)).astype(np.float32) * 0.2)
        d.bias = torch.from_numpy(rng.standard_normal(h).astype(np.float32) * 0.1)
        setattr(params, name, d)
    x = torch.from_numpy(rng.standard_normal((2, l, h)).astype(np.float32))
    mesh = Mesh(2, 1, 1)
    got = attention.mha(x, params, heads, dropout_rate=0.1, seed=77, training=True, mesh=mesh)
    q, k, v = attention._project_qkv(x, params, heads)
    ctx, _ = flash.flash_attention_fwd_plain(q, k, v, None, dropout_rate=0.1, seed=77 + 2**20)
    want = basic.dense(attention.merge_heads(ctx), params.out_proj.kernel, params.out_proj.bias)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    plain = attention.mha(x, params, heads, dropout_rate=0.1, seed=77, training=True)
    assert not torch.equal(got, plain)


# -- a rank's block of the one-process draws ---------------------------------


@pytest.mark.parametrize("data,model,split_last", [(2, 1, False), (4, 1, False), (2, 2, True),
                                                   (1, 2, True), (1, 2, False)])
def test_dropout_span_is_the_ranks_block_of_the_global_mask(data, model, split_last):
    b, l, c = 8, 5, 12
    x = torch.ones(b, l, c)
    seed = (2**32 - 5, 91)
    whole = basic.dropout(x, 0.3, seed, False)
    for rank in range(data * model):
        mesh = Mesh(data, model, rank)
        rows = batch_sharding(mesh, b)
        cols = slice(mesh.model_index * c // model, (mesh.model_index + 1) * c // model) \
            if split_last else slice(0, c)
        local = torch.ones(rows.stop - rows.start, l, cols.stop - cols.start)
        got = basic.dropout(local, 0.3, seed, False, global_span(mesh, local.shape, split_last))
        torch.testing.assert_close(got, whole[rows, :, cols], rtol=0, atol=0)


def test_element_index_wraps_past_2_to_the_32_as_the_whole_tensor_does():
    shape, full = (2, 3, 5), (4, 3, 2**30 + 7)
    got = basic._element_index(shape, None, ((2, 0, 2**30), full))
    lead = (torch.arange(2, 4)[:, None] * 3 + torch.arange(3)) * full[-1]
    want = (lead[..., None] + 2**30 + torch.arange(5)) & 0xFFFFFFFF
    want = torch.where(want >= 2**31, want - 2**32, want).to(torch.int32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_spec_augment_rows_are_the_global_draws_rows():
    x = torch.randn(6, 40, 8)
    embed = torch.randn(8)
    whole = specaugment.apply_spec_augmentation(torch.Generator().manual_seed(5), x, embed, 0.3, 4)
    for start in (0, 3):
        got = specaugment.apply_spec_augmentation(torch.Generator().manual_seed(5),
                                                  x[start:start + 3], embed, 0.3, 4,
                                                  rows=(start, 6))
        torch.testing.assert_close(got, whole[start:start + 3], rtol=0, atol=0)
    feat = specaugment.apply_feature_masking(torch.Generator().manual_seed(6), x, 0.3, 2)
    got = specaugment.apply_feature_masking(torch.Generator().manual_seed(6), x[3:], 0.3, 2,
                                            rows=(3, 6))
    torch.testing.assert_close(got, feat[3:], rtol=0, atol=0)


def test_negatives_and_gumbel_rows_are_the_global_draws_rows():
    mti = torch.rand(4, 30, generator=torch.Generator().manual_seed(1)) < 0.5
    mti[:, :3] = True
    whole = port_pretraining.sample_negative_indices(torch.Generator().manual_seed(2), mti, 5)
    got = port_pretraining.sample_negative_indices(torch.Generator().manual_seed(2), mti[2:], 5,
                                                   rows=(2, 4))
    # the indices are local to a rank's rows: row r's offset is r * L
    torch.testing.assert_close(got.long() + 2 * 30, whole[2:].long(), rtol=0, atol=0)


# -- the mesh ----------------------------------------------------------------


def test_one_process_mesh_rules_and_errors():
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.rank, mesh.size) == (1, 1, 0, 1)
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="model axis 2 does not divide device count 1"):
        make_mesh(model=2)
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        make_mesh(data=2)
    assert global_rows(mesh, 4) is None and global_span(mesh, (4, 3, 2)) is None
    assert batch_sharding(Mesh(2, 2, 3), 8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not divide the data axis"):
        batch_sharding(Mesh(2, 1, 0), 5)
    # rank = d * model + m, model minor (JAX's reshape(data, model))
    assert [(Mesh(2, 2, r).data_index, Mesh(2, 2, r).model_index) for r in range(4)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("env,cards,want", [
    ({"LOCAL_WORLD_SIZE": "2", "WORLD_SIZE": "2"}, 1, "gloo"),  # two ranks share the card
    ({"LOCAL_WORLD_SIZE": "2", "WORLD_SIZE": "4"}, 2, "nccl"),  # a card each, two hosts
    ({"WORLD_SIZE": "8"}, 8, "nccl"),  # no LOCAL_WORLD_SIZE: the world is this host
    ({"WORLD_SIZE": "8"}, 4, "gloo"),
], ids=["shared", "own", "world", "world_shared"])
def test_backend_rule_and_rank_device(monkeypatch, env, cards, want):
    """The backend follows from the ranks a host runs and its cards (NCCL
    refuses two ranks on one device); a rank's card is LOCAL_RANK modulo the
    cards; the CPU is gloo."""
    from gsoc_wav2vec2_tpu_torch.parallel import multihost
    from gsoc_wav2vec2_tpu_torch.utils import devices

    for name in ("LOCAL_WORLD_SIZE", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("LOCAL_RANK", "5")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert multihost.backend_for(torch.device("cuda", 0)) == want
    assert multihost.backend_for(torch.device("cpu")) == "gloo"
    assert devices.rank_device() == torch.device("cuda", 5 % cards)
    assert devices.rank_device("cpu") == torch.device("cpu")

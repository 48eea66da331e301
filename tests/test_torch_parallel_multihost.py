"""The multi-process helpers and the sharded evaluator over two gloo ranks
(the counterpart of the JAX package's
`tests/test_multiprocess_distributed.py:82-292, 444`).

`sync_run_id` adopts rank 0's id; `sync_min_count` and both forms of
`lockstep_batches` stop uneven streams (3 and 2 batches) together;
`lockstep_bucket_batches` runs diverging bucket orders at each step's
longest bucket, repadded by the loader; `host_local_batch_to_global`
refuses a global batch the data axis does not divide; `replicated` passes
a tensor equal on every rank and refuses one that differs.  Two ranks'
`evaluate_bucketed` / `evaluate_padded` WER (rank 0 five samples, rank 1
one, so lockstep pads rank 1 with two dummy batches in each mode) equals one
process's exactly, and so does every sample's transcript, for the robust
family (masked) and the base family (no mask: a sample padded past its own
bucket would decode otherwise).
"""

import pytest
import torch

from tests import torch_parallel_ranks as R

torch.set_num_threads(2)


def test_multihost_helpers_over_two_ranks(tmp_path):
    outs = R.run_ranks("multihost_helpers", 2, {}, tmp_path)
    for o in outs:
        assert o["run_id"] == "host-0-id"
        assert o["flag_steps"] == 2 and o["counted_steps"] == 2
        assert o["min_count"] == 2 and o["min_none"] is None
        assert o["uneven_refused"]
        assert o["replicated_same"] and o["replicated_differs_refused"]
        # both flushes at the consensus bucket: 2000 twice
        assert o["bucket_shapes"] == [2000, 2000]
    # rank 0's first batch is its 1000-bucket (800, 900 samples), repadded to
    # 2000 with the mask kept to the real samples
    assert outs[0]["bucket_masks"][0] == [800, 900]
    assert sorted(outs[1]["bucket_masks"][0]) == [1600, 1700]


def _assert_wer_equal_one_process(robust, tmp_path):
    want = R.eval_wer(shard=False, robust=robust)
    assert want["n"] == 6
    outs = R.run_ranks("eval_wer", 2, {"robust": robust}, tmp_path)
    for o in outs:
        assert o["n"] == 6  # the global count
        assert o["wer"] == want["wer"]
        assert o["padded"] == want["padded"]
    # rank 1's one flush, then dummies while rank 0 runs its other two
    assert outs[0]["dummies"] == [0, 0] and outs[1]["dummies"] == [2, 2]
    # every sample's transcript is one process's: the ranks hold a split
    for key in ("texts", "padded_texts"):
        assert outs[0][key].keys().isdisjoint(outs[1][key])
        assert {**outs[0][key], **outs[1][key]} == want[key]


def test_two_rank_bucketed_and_padded_wer_equal_one_process(tmp_path):
    _assert_wer_equal_one_process(True, tmp_path)


def test_two_rank_base_family_bucketed_wer_equals_one_process(tmp_path):
    """No mask: a sample padded past its own bucket would decode otherwise."""
    _assert_wer_equal_one_process(False, tmp_path)


def test_evaluator_refuses_a_model_axis():
    from gsoc_wav2vec2_tpu_torch.evaluation import GreedyCTCEvaluator
    from gsoc_wav2vec2_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="data axis only"):
        GreedyCTCEvaluator(torch.nn.Module(), mesh=Mesh(data=1, model=2, rank=0))

"""Training with every agent a process (4 gloo ranks on the CPU) against
the port on all agents in one process, 20 rounds each.

The ranks run ``tests/torch_dist_worker.py::train_all`` (one spawn for the
module, one CPU thread a rank); each rank runs the one-process oracle too,
so both runs share a thread count.  Held here:

* the quickstart's PORTER-GC on the dense executor, PORTER-DP on the ring
  MLP, dp-csgp over the ring codec (``directed:ring_skips``) and CHOCO-SGD
  on the ring with bf16 planes: the gathered final state within 1e-6 of
  the one-process state.  The three MLP runs are bitwise.  The logistic
  regression is not, from its first gradient on: under ``vmap`` over one
  agent ``f @ w`` is a matrix-vector product, over four a batched matrix
  product, and MKL rounds the two an ulp apart;
* every rank's metrics are the one-process metrics: the loss, its mean
  over the agents bitwise where the gradients are, and the wire bytes
  exactly; the consensus errors and ``v_norm``, sums over the ranks in
  another order, within 1e-6 relative; and every rank reports the same
  bits;
* every draw site: each rank's draws are bitwise its rows of the
  one-process draws (batch indices, LM tokens and patches, DP noise, SR
  words, the qsgd dither, the random-k mask, the low-rank sketch, the
  codec's qsgd noise);
* the LM smoke config (tinyllama, ring gossip, bf16 planes) through
  ``build_train_step(group=)`` for 2 rounds.
"""

import numpy as np
import pytest

import torch_dist_worker as W
from repro_torch.launch import mesh

MLP_CASES = [c for c in W.TRAIN if "mlp" in c]
DRAW_SITES = ["batch indices", "lm tokens and patches", "dp noise",
              "qsgd dither", "random_k mask", "low_rank sketch", "sr words",
              "codec noise"]
REDUCED = ("consensus_x", "consensus_v", "v_norm", "clip_residual")


@pytest.fixture(scope="module")
def ranks():
    return mesh.spawn_agents(W.train_all, 4, device="cpu", threads=1,
                             timeout_s=120)


@pytest.mark.parametrize("case", list(W.TRAIN))
def test_final_x_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        got = rank["train"][case]
        assert got["x_diff"] <= 1e-6, got["x_diff"]
        assert got["x_scale"] > 0.05           # the run moved x


@pytest.mark.parametrize("case", MLP_CASES)
def test_mlp_runs_are_bitwise(ranks, case):
    for rank in ranks:
        got = rank["train"][case]
        assert got["state_bitwise"] and got["x_diff"] == 0.0


@pytest.mark.parametrize("case", list(W.TRAIN))
def test_metrics_are_the_one_process_metrics(ranks, case):
    bitwise = case in MLP_CASES
    for rank in ranks:
        got = rank["train"][case]
        one, proc = got["metrics_one"], got["metrics_proc"]
        assert set(one) == set(proc)
        assert len(proc["loss"]) == W.ROUNDS
        np.testing.assert_array_equal(proc["wire_bytes"], one["wire_bytes"])
        if bitwise:
            np.testing.assert_array_equal(proc["loss"], one["loss"])
        else:
            np.testing.assert_allclose(proc["loss"], one["loss"], rtol=1e-6)
        for k in REDUCED:
            if k in one:
                np.testing.assert_allclose(proc[k], one[k], rtol=1e-6,
                                           err_msg=k)


@pytest.mark.parametrize("case", list(W.TRAIN))
def test_average_params_over_the_group_is_the_one_process_mean(ranks, case):
    """x-bar from one all-reduce of the ranks' rows (the sum in another
    order than the one-process mean's) within 1e-6."""
    for rank in ranks:
        assert rank["train"][case]["avg_diff"] <= 1e-6


@pytest.mark.parametrize("case", list(W.TRAIN))
def test_every_rank_reports_the_same_metrics(ranks, case):
    first = ranks[0]["train"][case]["metrics_proc"]
    for rank in ranks[1:]:
        for k, v in rank["train"][case]["metrics_proc"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


@pytest.mark.parametrize("site", DRAW_SITES)
def test_each_rank_draws_its_rows_of_the_one_process_draws(ranks, site):
    assert all(rank["lm"]["draws"][site] for rank in ranks)


def test_lm_smoke_config_trains_across_processes(ranks):
    for rank in ranks:
        lm = rank["lm"]
        assert lm["losses_proc"] == lm["losses_one"]
        assert np.all(np.isfinite(lm["losses_proc"]))
        assert lm["x_diff"] <= 1e-6
        assert lm["state_bitwise"]

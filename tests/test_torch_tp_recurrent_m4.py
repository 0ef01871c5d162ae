"""rwkv6, the hybrid and the encoder-decoder at M = 4: a ``(data 2, model
4)`` grid of 8 gloo ranks on the CPU, the smoke configs of
``tests/test_torch_tp_recurrent.py`` split four ways.  rwkv6 holds one
head a rank, zamba2 two Mamba2 heads (138 of ``w_in``'s 552 columns, 72
of the conv's 288 channels) and one head of the shared block, seamless
one head a rank.

Held here: every family's loss and gradient within 1e-5 of the
reference's unsharded ones (as ``tests/test_torch_tp_recurrent.py``
measures them); one PORTER-GC round (ring, shard-local
``block_top_k``) for each family, one PORTER-DP round on the hybrid and
one dp-csgp round on the encoder-decoder, within 1e-6 of all agents in
one process; the replicated leaves and the push-sum weights bitwise
across the 4 model ranks; the census per axis; the frames the agent's
rows on every model rank.
"""

import pytest

from test_torch_tp_recurrent import (LABELS, VARIANTS, check_recurrent,
                                     test_census_per_axis_within_the_budget
                                     as census_case, spawn_recurrent)

M4_VARIANTS = tuple(v for v in VARIANTS
                    if v[0] in ("hybrid dp", "encdec csgp"))
ALL = LABELS + [v[0] for v in M4_VARIANTS]


@pytest.fixture(scope="module")
def ranks():
    return spawn_recurrent(4, M4_VARIANTS, seed=2)


@pytest.mark.parametrize("label", LABELS)
def test_loss_and_grads_at_m4_are_the_reference(ranks, label):
    check_recurrent(ranks, 4, label, seed=2)


@pytest.mark.parametrize("case", ALL)
def test_one_round_at_m4_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        assert rank[case]["finite"]
        assert rank[case]["x_diff"] <= 1e-6, rank[case]["x_diff"]


@pytest.mark.parametrize("case", ALL)
def test_replicated_leaves_bitwise_across_four_model_ranks(ranks, case):
    for rank in ranks:
        assert rank[case]["replicated"]


@pytest.mark.parametrize("case", ALL)
def test_census_per_axis_at_m4_within_the_budget(ranks, case):
    census_case(ranks, case)


def test_push_sum_weights_bitwise_across_four_model_ranks(ranks):
    for rank in ranks:
        assert rank["encdec csgp"]["weights_bitwise"]
        assert rank["encdec csgp"]["xw_diff"] <= 1e-6


def test_frames_on_four_model_ranks_are_the_agents_rows(ranks):
    for rank in ranks:
        got = rank["frames"]
        assert got["rows"] == {"frames": True, "tokens": True}, got
        assert got["same_on_model_ranks"]

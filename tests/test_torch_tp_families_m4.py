"""The decoder families at M = 4: a ``(data 2, model 4)`` grid of 8 gloo
ranks on the CPU, the cases of ``tests/test_torch_tp_families.py`` split
four ways.  grok's and arctic's two kv heads and paligemma's one now lie
below a rank (each rank holds a slice of a kv head's columns and attends
with the gathered head), MLA holds one head a rank, arctic's 16 experts
four a rank.

Held here: every family's loss and gradient within 1e-5 of the
reference's unsharded ones; one PORTER-GC round (ring, whole-leaf top-k)
for MLA, the expert-parallel MoE and the VLM, one dp-csgp round on the
VLM (ring, shard-local ``block_top_k``) and one PORTER-DP round on the
expert-parallel MoE (ring, whole-leaf top-k), within 1e-6 of all agents
in one process; the replicated leaves and the push-sum weights bitwise
across the 4 model ranks; the expert-parallel combine bitwise the
one-card one.
"""

import pytest

from test_torch_tp_families import FAMILIES, check_against_reference, spawn

CASES = ["mla", "moe-expert", "vlm"]
VARIANTS = (("vlm csgp ring", "vlm", "csgp", "ring", "dense", None,
             "block_top_k", 1),
            ("moe-expert dp", "moe-expert", "dp", "ring", "dense", None,
             "top_k", 1))
ALL = CASES + [v[0] for v in VARIANTS]


@pytest.fixture(scope="module")
def ranks():
    return spawn(4, CASES, VARIANTS, seed=2)


@pytest.mark.parametrize("label", FAMILIES)
def test_loss_and_grads_at_m4_are_the_reference(ranks, label):
    check_against_reference(ranks, 4, label, seed=2)


@pytest.mark.parametrize("case", ALL)
def test_one_round_at_m4_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        assert rank[case]["finite"]
        assert rank[case]["x_diff"] <= 1e-6, rank[case]["x_diff"]


@pytest.mark.parametrize("case", ALL)
def test_replicated_leaves_bitwise_across_four_model_ranks(ranks, case):
    for rank in ranks:
        assert rank[case]["replicated"]


def test_push_sum_weights_bitwise_across_four_model_ranks(ranks):
    for rank in ranks:
        assert rank["vlm csgp ring"]["weights_bitwise"]


def test_expert_parallel_combine_at_m4_is_bitwise(ranks):
    for rank in ranks:
        got = rank["combine"]
        assert got["bitwise"] and got["aux_bitwise"], got

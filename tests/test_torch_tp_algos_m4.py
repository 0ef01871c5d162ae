"""dsgd, choco and the qsgd packed codec on a ``(data 2, model 4)`` grid of
8 gloo ranks on the CPU, on the tinyllama smoke config widened to 4 kv
heads (whole kv heads a shard), against the port on all agents in one
process (``tests/torch_tp_worker.py::algo_m4_cases``).

Held here, as ``tests/test_torch_tp_algos.py`` holds them at M = 2: one
round of dsgd (smooth clip) and choco (shard-local ``block_top_k``) on
the ring and of PORTER-GC on the qsgd packed codec at 7 levels, the
gathered x and every state buffer within 1e-6 of the one-process round
and the forced first round bitwise; the replicated leaves bitwise across
the 4 model ranks; the metrics the one-process metrics; and the codec's
per-shard draw, ``c`` bitwise the one-card twin's block on every rank.
"""

import pytest

import torch_tp_worker as W
from repro_torch.launch import mesh

LABELS = ["dsgd", "choco", "gc-qsgd-packed"]


@pytest.fixture(scope="module")
def ranks():
    return mesh.spawn_agents(W.algo_m4_cases, 8, model=4, device="cpu",
                             threads=1, timeout_s=240)


@pytest.mark.parametrize("label", LABELS)
def test_one_round_at_m4_within_1e6_of_one_process(ranks, label):
    for rank in ranks:
        got = rank[label]
        assert got["finite"] and got["x_diff"] <= 1e-6, got["x_diff"]
        assert max(got["field_diff"].values()) <= 1e-6, got["field_diff"]
        assert got["forced"]["bitwise"], got["forced"]["x_diff"]


@pytest.mark.parametrize("label", LABELS)
def test_replicated_leaves_bitwise_across_four_model_ranks(ranks, label):
    for rank in ranks:
        assert all(rank[label]["replicated"].values())


@pytest.mark.parametrize("label", LABELS)
def test_metrics_at_m4_are_the_one_process_metrics(ranks, label):
    for rank in ranks:
        for m1, m2 in zip(rank[label]["metrics_one"],
                          rank[label]["metrics_proc"]):
            if label != "gc-qsgd-packed":   # the twin's wire is dense
                assert m2["wire_bytes"] == m1["wire_bytes"]
            for key in ("loss", "consensus_x", "consensus_v", "v_norm"):
                if key in m1:
                    assert abs(m2[key] - m1[key]) <= 1e-6 * abs(m1[key]), key


@pytest.mark.parametrize("how", ["injected", "drawn"])
@pytest.mark.parametrize("mode", ["ring", "packed"])
def test_qsgd_codec_draw_at_m4_is_the_twin(ranks, how, mode):
    for rank in ranks:
        got = rank["codec"][f"{how} {mode}"]
        assert got["c_bitwise"] and got["ps_bitwise"]
        assert got["wc_diff"] <= 1e-6
    assert all(r["codec"]["unsharded_draw_differs"] for r in ranks)

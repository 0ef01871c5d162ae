"""The model axis at M = 4: a ``(data 2, model 4)`` grid of 8 gloo ranks on
the CPU, on the tinyllama smoke config widened to 4 kv heads (whole kv
heads a shard; ``tests/test_torch_tp_families_m4.py`` splits grok's and
arctic's two and paligemma's one below a rank), against the JAX package's
unsharded loss and gradient and the port on all agents in one process.

Held here: the loss and every leaf's gradient within 1e-5 of the
reference's; one PORTER-GC and one PORTER-DP round within 1e-6 of the
one-process round (the whole-leaf compressor); 3 rounds with bf16 planes
and the shard-local ``block_top_k``; the replicated leaves bitwise across
the 4 model ranks; and a ``(data 2)`` grid built by the same code with
``M = 1`` bitwise all agents in one process (the agents-only grid).
"""

import numpy as np
import pytest

import torch_tp_worker as W
from test_torch_tp_train import (_params_and_tokens, assemble,
                                 reference_loss_and_grads)
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.nn.module import leaf_specs

OVER = {"n_kv_heads": 4}


@pytest.fixture(scope="module")
def ranks():
    cfg = W.smoke(**OVER)
    np_params, tokens = _params_and_tokens(cfg, seed=2)
    out = mesh.spawn_agents(W.m4_cases, 8, model=4, device="cpu",
                            threads=1, timeout_s=240)
    grads = mesh.spawn_agents(W.grads, 8, (cfg, np_params, tokens),
                              model=4, device="cpu", threads=1,
                              timeout_s=120)
    for rank, g in zip(out, grads):
        rank["grads"] = g
    return out


def test_loss_and_grads_at_m4_are_the_reference(ranks):
    cfg = W.smoke(**OVER)
    np_params, tokens = _params_and_tokens(cfg, seed=2)
    want_loss, want = reference_loss_and_grads("tinyllama-1.1b", np_params,
                                               tokens, **OVER)
    specs = leaf_specs(build_model(cfg, device="cpu"))
    for agent in range(2):
        blocks = [ranks[agent * 4 + m]["grads"] for m in range(4)]
        assert all(abs(b["loss"] - want_loss) <= 1e-5 * abs(want_loss)
                   for b in blocks)
        got = assemble([b["grads"] for b in blocks], specs, 4)
        for path, g in got.items():
            scale = float(np.abs(want[path]).max())
            assert float(np.abs(g - want[path]).max()) <= 1e-5 * scale, path


@pytest.mark.parametrize("case", ["gc", "dp"])
def test_one_round_at_m4_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        assert rank[case]["x_diff"] <= 1e-6, rank[case]["x_diff"]


def test_bf16_shard_local_rounds_at_m4_stay_near_one_process(ranks):
    for rank in ranks:
        got = rank["gc-local-bf16"]
        assert got["finite"] and got["x_diff"] <= 1e-4, got["x_diff"]


@pytest.mark.parametrize("case", ["gc", "dp", "gc-local-bf16"])
def test_replicated_leaves_bitwise_across_four_model_ranks(ranks, case):
    for rank in ranks:
        assert rank[case]["replicated"]


@pytest.mark.parametrize("case", ["gc", "dp", "gc-local-bf16"])
def test_shipped_bytes_at_m4_are_the_model_plus_3_replicated(ranks, case):
    for agent in range(2):
        four = [ranks[agent * 4 + m][case] for m in range(4)]
        assert (sum(r["shipped"] for r in four)
                == four[0]["model_bytes"] + 3 * four[0]["replicated_bytes"])


def test_m1_grid_is_the_one_process_run_bitwise():
    out = mesh.spawn_agents(W.m1_case, 2, device="cpu", threads=1,
                            timeout_s=120)
    for rank in out:
        assert rank["bitwise"] and rank["sharded"]
        assert rank["model_size"] == 1 and rank["axes"] == ("data",)
        assert rank["loss"][0] == rank["loss"][1]

"""The model axis across processes: a ``(data 2, model 2)`` grid of 4 gloo
ranks on the CPU against the port on all agents in one process, and the
tensor-parallel loss and gradient against the JAX package's unsharded
ones.

The ranks run ``tests/torch_tp_worker.py::train_cases`` (one spawn for the
module, one CPU thread a rank).  Held here:

* the tensor-parallel loss and every leaf's gradient of the tinyllama
  smoke config within 1e-5 of the reference's ``loss`` and ``jax.grad``
  on the same parameters (the reference's own model-sharded step raises
  under jax 0.9.0: ``tests/test_torch_tp_specs.py``);
* one PORTER-GC and one PORTER-DP round on the ring, the whole-leaf
  compressor (``local_compress=False``): the gathered x within 1e-6 of
  the one-process round; the shard-local ``block_top_k``, the dense and
  plain packed executors, both codec executors, chatglm3's and danube's
  smoke configs alike against the one-process round with the per-shard
  compressor; the ef updates on per-shard planes bitwise the one-card
  ones, block for block;
* the replicated leaves (the norms) bitwise across the model ranks of an
  agent in every state buffer, also after 5 rounds with bf16 planes;
* every rank's metrics the one-process metrics (loss and sums within 1e-6
  relative, the wire bytes exactly where the wire is the same);
* the planted faults caught: a shard-local clip norm, each rank's own DP
  noise, and a skipped backward all-reduce;
* the census per axis: the agent-axis collectives within the executor's
  budget, the model-axis ones counted apart; the bytes shipped summed
  over an agent's model ranks equal to the reference's byte model plus
  ``(M - 1)`` times the replicated leaves' bytes, exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_tp_worker as W
from lm_parity import flat, jbuild_model, jparams
from repro.configs import get_smoke as jget_smoke
from repro_torch import convert
from repro_torch.core.agents import model_shard
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.nn.module import leaf_specs

ONE_ROUND = ["gc", "dp", "gc-local-block", "gc-dense", "gc-packed",
             "gc-ring-codec", "gc-packed-codec", "gc-chatglm3", "gc-danube"]
ALL = ONE_ROUND + ["gc-5"]
SUMS = ("consensus_x", "consensus_v", "v_norm")


def _params_and_tokens(cfg, seed=0):
    drawn = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (W.BATCH, W.SEQ)).astype(np.int32)
    return convert.to_numpy(drawn), tokens


@pytest.fixture(scope="module")
def ranks():
    cfg = W.smoke()
    np_params, tokens = _params_and_tokens(cfg)
    out = mesh.spawn_agents(W.train_cases, 4, model=2, device="cpu",
                            threads=1, timeout_s=240)
    grads = mesh.spawn_agents(W.grads, 4, (cfg, np_params, tokens),
                              model=2, device="cpu", threads=1,
                              timeout_s=120)
    for rank, g in zip(out, grads):
        rank["grads"] = g
    return out


def reference_loss_and_grads(arch, np_params, tokens, **over):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=jax.numpy.float32,
                               remat=False, **over)
    loss, g = jax.value_and_grad(jbuild_model(jcfg).loss)(
        jparams(np_params), {"tokens": jax.numpy.asarray(tokens)})
    return float(loss), {k: np.asarray(v) for k, v in flat(g).items()}


def assemble(blocks, specs, model):
    """The whole leaves from the model ranks' blocks (one agent's)."""
    out = {}
    for path, spec in flat(specs).items():
        parts = [flat(b)[path].numpy() for b in blocks]
        dim = spec.model_dim
        out[path] = parts[0] if dim is None else np.concatenate(parts, dim)
    return out


def test_tensor_parallel_loss_and_grads_are_the_reference(ranks):
    cfg = W.smoke()
    np_params, tokens = _params_and_tokens(cfg)
    want_loss, want = reference_loss_and_grads("tinyllama-1.1b", np_params,
                                               tokens)
    specs = leaf_specs(build_model(cfg, device="cpu"))
    for agent in range(2):
        blocks = [ranks[agent * 2 + m]["grads"] for m in range(2)]
        for b in blocks:
            assert abs(b["loss"] - want_loss) <= 1e-5 * abs(want_loss)
        got = assemble([b["grads"] for b in blocks], specs, 2)
        assert got.keys() == want.keys()
        for path, g in got.items():
            scale = float(np.abs(want[path]).max())
            err = float(np.abs(g - want[path]).max())
            assert err <= 1e-5 * scale, (path, err, scale)


@pytest.mark.parametrize("case", ["gc", "dp"])
def test_one_round_x_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        assert rank[case]["x_diff"] <= 1e-6, rank[case]["x_diff"]
        assert rank[case]["finite"]


@pytest.mark.parametrize("case", ONE_ROUND[2:])
def test_per_shard_rounds_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        assert rank[case]["x_diff"] <= 1e-6, rank[case]["x_diff"]


def test_five_bf16_rounds_stay_near_one_process(ranks):
    for rank in ranks:
        assert rank["gc-5"]["finite"]
        assert rank["gc-5"]["x_diff"] <= 1e-4, rank["gc-5"]["x_diff"]


@pytest.mark.parametrize("update", ["track", "step"])
def test_ef_updates_on_per_shard_planes_are_bitwise(ranks, update):
    for rank in ranks:
        assert rank["ef"][update]


@pytest.mark.parametrize("case", ALL)
def test_replicated_leaves_are_bitwise_across_model_ranks(ranks, case):
    for rank in ranks:
        assert rank[case]["replicated"]


@pytest.mark.parametrize("case", ["gc", "dp", "gc-local-block", "gc-dense",
                                  "gc-packed"])
def test_metrics_are_the_one_process_metrics(ranks, case):
    for rank in ranks:
        one, proc = rank[case]["metrics_one"], rank[case]["metrics_proc"]
        for m1, m2 in zip(one, proc):
            assert m2["wire_bytes"] == m1["wire_bytes"]
            for key in ("loss",) + SUMS:
                assert abs(m2[key] - m1[key]) <= 1e-6 * abs(m1[key]), key
    first = ranks[0][case]["metrics_proc"]
    assert all(r[case]["metrics_proc"] == first for r in ranks)


@pytest.mark.parametrize("check", ["clip", "noise", "grad"])
def test_planted_faults_are_caught(ranks, check):
    """The sound path reads within the gate, the planted fault far out."""
    gate = {"clip": 1e-6, "noise": 1e-6, "grad": 1e-5}[check]
    for rank in ranks:
        f = rank["faults"]
        assert f[check] <= gate, (check, f[check])
        assert f[check + "_fault"] > 100 * gate, (check, f[check + "_fault"])


@pytest.mark.parametrize("case", ONE_ROUND)
def test_census_per_axis_within_the_budget(ranks, case):
    for rank in ranks:
        agent, model = rank[case]["census"]
        budget = rank[case]["budget"]
        n_leaves = rank[case]["n_leaves"]
        gossip = {k: v for k, v in agent.items() if k != "all-reduce"}
        # two exchanges a round, each within the executor's budget
        for cat, count in gossip.items():
            assert cat in budget and count <= 2 * budget[cat] * n_leaves
        assert agent["all-reduce"] == 2            # the metrics
        assert model["all-reduce"] >= 2             # the clip, the metrics
        assert set(model) <= {"all-reduce", "all-gather"}


@pytest.mark.parametrize("case", ONE_ROUND[2:])
def test_shipped_bytes_are_the_model_plus_the_replicated_leaves(ranks, case):
    for agent in range(2):
        pair = [ranks[agent * 2 + m][case] for m in range(2)]
        total = sum(r["shipped"] for r in pair)
        assert total == pair[0]["model_bytes"] + pair[0]["replicated_bytes"]


def test_windows_count_per_leaf_and_model_shard(ranks):
    """The smoke config's packed windows: each sharded leaf's two shards
    pad apart, the replicated leaves once."""
    cfg = W.smoke()
    specs = flat(leaf_specs(build_model(cfg, device="cpu")))
    want = 0
    for spec in specs.values():
        size = int(np.prod(spec.shape))
        want += (-(-size // 2048) if spec.model_dim is None
                 else 2 * -(-(size // 2) // 2048))
    assert all(r["gc"]["windows"] == want for r in ranks)


def test_model_shard_takes_equal_slices():
    full = torch.arange(24).reshape(2, 12)
    assert torch.equal(model_shard(full, 1, 2, 3), full[:, 8:12])
    assert model_shard(full, None, 1, 3) is full

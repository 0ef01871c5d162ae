"""The rest of the decoder bundle on the model axis: a ``(data 2, model 2)``
grid of 4 gloo ranks on the CPU for MLA (minicpm3), ffn-parallel MoE
(grok-1), expert-parallel MoE (arctic at 16 experts), the VLM with its one
kv head split over the ranks (paligemma), the tied vocab-parallel
embedding, and the d_model-sharded embedding tied (minicpm3 at vocab 500)
and untied (tinyllama at vocab 500), each a smoke config in f32.

The ranks run ``tests/torch_tp_worker.py::family_cases`` (one spawn for
the module, one CPU thread a rank).  Held here:

* the tensor-parallel loss and every leaf's gradient within 1e-5 of the
  reference's ``loss`` and ``jax.grad`` on the same unsharded parameters
  (the reference's own model-sharded step raises under jax 0.9.0:
  ``tests/test_torch_tp_specs.py``), bridged through ``repro_torch.convert``;
* one PORTER-GC round on the ring (whole-leaf top-k) for each, PORTER-DP
  on MLA and on the expert-parallel MoE, BEER on the expert-parallel MoE,
  dp-csgp on the VLM and on the ffn-parallel MoE (ring, shard-local
  ``block_top_k``) and on MLA over the packed codec on a directed
  schedule, and PORTER-GC over the packed codec on the
  ffn-parallel MoE: the gathered x within 1e-6 of all agents in one
  process;
* the replicated leaves bitwise across the model ranks of an agent in
  every state buffer, and dp-csgp's push-sum weights too (over 5 rounds
  on the directed schedule the weights move and stay within 1e-6 of one
  process);
* the census per axis within the executor's budget;
* the expert-parallel combine bitwise the one-card combine in f32.
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
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.nn import tensor_parallel as TP
from repro_torch.nn.module import leaf_specs

FAMILIES = list(W.FAMILIES)
# (name, family, variant, gossip, wire, schedule, compressor, rounds)
DIGRAPH = "directed:digraph,p=0.5,period=8,seed=1"
VARIANTS = (
    ("mla dp", "mla", "dp", "ring", "dense", None, "top_k", 1),
    ("moe-expert dp", "moe-expert", "dp", "ring", "dense", None, "top_k",
     1),
    ("moe-ffn csgp", "moe-ffn", "csgp", "ring", "dense", None,
     "block_top_k", 1),
    ("moe-expert beer", "moe-expert", "beer", "ring", "dense", None,
     "top_k", 1),
    ("vlm csgp ring", "vlm", "csgp", "ring", "dense", None, "block_top_k",
     1),
    ("mla csgp codec", "mla", "csgp", "packed", "packed_bits", DIGRAPH,
     "top_k", 1),
    ("mla csgp codec 5", "mla", "csgp", "packed", "packed_bits", DIGRAPH,
     "top_k", 5),
    ("moe-ffn gc codec", "moe-ffn", "gc", "packed", "packed_bits", None,
     "top_k", 1),
)
ONE_ROUND = FAMILIES + [v[0] for v in VARIANTS if v[-1] == 1]
CSGP = [v[0] for v in VARIANTS if v[2] == "csgp"]


def inputs(label, seed=0):
    """One replica's f32 parameters (the port's draw, as numpy) and a
    batch (numpy, from a seed): tokens, and the VLM's patches or the
    encoder-decoder's frames."""
    cfg = W.family_cfg(label)
    drawn = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (
        W.BATCH, W.SEQ - cfg.n_prefix)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (W.BATCH, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (W.BATCH, W.SEQ, cfg.frontend_dim)).astype(np.float32)
    return convert.to_numpy(drawn), batch


def spawn(model, cases, variants, seed=0, labels=FAMILIES,
          fn=W.family_cases):
    """``fn(group, cases, variants, grad_inputs)`` on a ``(data 2, model
    model)`` grid of gloo ranks, ``grad_inputs`` for every label of
    ``labels``."""
    grad_inputs = {label: inputs(label, seed) for label in labels}
    return mesh.spawn_agents(fn, 2 * model,
                             (cases, variants, grad_inputs), model=model,
                             device="cpu", threads=1, timeout_s=300)


@pytest.fixture(scope="module")
def ranks():
    return spawn(2, FAMILIES, VARIANTS)


def reference(label, np_params, np_batch):
    """The reference's unsharded loss and gradient (f32)."""
    arch, over = W.family_of(label)
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=jax.numpy.float32,
                               remat=False, **dict(over))
    loss, g = jax.value_and_grad(jbuild_model(jcfg).loss)(
        jparams(np_params),
        {k: jax.numpy.asarray(v) for k, v in np_batch.items()})
    return float(loss), {k: np.asarray(v) for k, v in flat(g).items()}


def check_against_reference(ranks, model, label, seed=0):
    """Every rank's loss and its agent's assembled gradient within 1e-5
    of the reference's."""
    np_params, np_batch = inputs(label, seed)
    want_loss, want = reference(label, np_params, np_batch)
    specs = flat(leaf_specs(build_model(W.family_cfg(label), device="cpu")))
    for agent in range(2):
        blocks = [ranks[agent * model + m][f"grads {label}"]
                  for m in range(model)]
        for b in blocks:
            assert abs(b["loss"] - want_loss) <= 1e-5 * abs(want_loss)
        parts = [flat(b["grads"]) for b in blocks]
        assert parts[0].keys() == want.keys()
        for path, spec in specs.items():
            got = [p[path].numpy() for p in parts]
            got = (got[0] if spec.model_dim is None
                   else np.concatenate(got, spec.model_dim))
            scale = float(np.abs(want[path]).max())
            err = float(np.abs(got - want[path]).max())
            assert err <= 1e-5 * scale, (label, path, err, scale)


@pytest.mark.parametrize("label", FAMILIES)
def test_loss_and_grads_are_the_reference(ranks, label):
    check_against_reference(ranks, 2, label)


@pytest.mark.parametrize("case", ONE_ROUND)
def test_one_round_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        assert rank[case]["finite"]
        assert rank[case]["x_diff"] <= 1e-6, rank[case]["x_diff"]


@pytest.mark.parametrize("case", ONE_ROUND + ["mla csgp codec 5"])
def test_replicated_leaves_are_bitwise_across_model_ranks(ranks, case):
    for rank in ranks:
        assert rank[case]["replicated"]


@pytest.mark.parametrize("case", CSGP)
def test_push_sum_weights_are_bitwise_across_model_ranks(ranks, case):
    for rank in ranks:
        assert rank[case]["weights_bitwise"]
        assert rank[case]["xw_diff"] <= 1e-6


def test_push_sum_weights_move_on_the_directed_schedule(ranks):
    """Over 5 rounds of the digraph (at two agents its first tables are
    not doubly stochastic, so the mirror ``m_w = W_0 1`` starts the
    weights moving) the weights leave 1, as one process's do, and x stays
    near one process."""
    for rank in ranks:
        got = rank["mla csgp codec 5"]
        assert got["xw_moved"] > 1e-3, got["xw_moved"]
        assert got["xw_diff"] <= 1e-6 and got["x_diff"] <= 1e-5


@pytest.mark.parametrize("case", ONE_ROUND)
def test_census_per_axis_within_the_budget(ranks, case):
    for rank in ranks:
        agent, model = rank[case]["census"]
        budget = rank[case]["budget"]
        n_leaves = rank[case]["n_leaves"]
        gossip = {k: v for k, v in agent.items() if k != "all-reduce"}
        for cat, count in gossip.items():      # two exchanges a round
            assert cat in budget and count <= 2 * budget[cat] * n_leaves
        assert agent["all-reduce"] == 2            # the metrics
        assert model["all-reduce"] >= 2             # the clip, the metrics
        assert set(model) <= {"all-reduce", "all-gather"}


def test_expert_parallel_combine_is_the_one_card_combine_bitwise(ranks):
    """16 experts over 2 ranks, top-2, f32: each choice's term comes from
    the rank that holds its expert and the other adds an exact 0, so the
    all-reduced output is the one-card layer's bit for bit, aux loss
    included."""
    for rank in ranks:
        got = rank["combine"]
        assert got["bitwise"] and got["aux_bitwise"], got


class _Grid:
    def __init__(self, model_size, model_index=0):
        self.model_size, self.model_index = model_size, model_index


@pytest.mark.parametrize("h,hk,m,want", [
    (4, 2, 2, [TP.Heads(2, 1)] * 2),                    # whole kv heads
    (32, 4, 4, [TP.Heads(8, 1)] * 4),
    (4, 1, 2, [TP.Heads(2, 1, True, 0)] * 2),           # paligemma smoke
    (8, 1, 4, [TP.Heads(2, 1, True, 0)] * 4),           # paligemma
    (4, 2, 4, [TP.Heads(1, 1, True, m // 2) for m in range(4)]),
    (40, 40, 2, [TP.Heads(20, 20)] * 2),                # MLA's heads
])
def test_local_heads_follow_the_specs(h, hk, m, want):
    assert [TP.local_heads(h, hk, _Grid(m, i)) for i in range(m)] == want


@pytest.mark.parametrize("h,hk,m", [(6, 3, 2), (6, 2, 4), (4, 4, 8)])
def test_local_heads_refuse_a_split_across_kv_groups(h, hk, m):
    with pytest.raises(ValueError, match="n_kv_heads % M"):
        TP.local_heads(h, hk, _Grid(m))

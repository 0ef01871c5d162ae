"""rwkv6, the Mamba2 hybrid and the encoder-decoder on the model axis: a
``(data 2, model 2)`` grid of 4 gloo ranks on the CPU for the rwkv6-7b
(4 heads x 32), zamba2-7b (8 heads x 32, state 16, 552 ``w_in`` columns,
the shared block twice) and seamless-m4t-medium (4 heads, frontend 64)
smoke configs in f32.

The ranks run ``tests/torch_tp_worker.py::recurrent_cases`` (one spawn for
the module, one CPU thread a rank).  Held here:

* the tensor-parallel loss within 1e-5 of the reference's ``loss`` and
  every leaf's gradient within 1e-5 of ``jax.grad``'s, normwise (the
  one-card loss tests' measure, ``tests/test_torch_lm_loss.py``), on the
  same unsharded parameters bridged through ``repro_torch.convert`` (the
  reference's own model-sharded step raises:
  ``tests/test_torch_tp_specs.py``); and every leaf within 1e-5 of the
  port's one-card gradient in its largest difference over its largest
  magnitude.  The decoder families' measure (the largest difference
  against the reference's) is no gate here: the hybrid's one-card
  gradient of ``dt_bias`` already lies 8.2e-6 from the reference's by it
  (16 steps of the per-token recurrence in f32), and the split adds its
  own ~4e-6;
* one round against all agents in one process, the gathered x within
  1e-6: PORTER-GC on the ring with the shard-local ``block_top_k`` for
  each family, PORTER-DP on rwkv6 and on the hybrid (the packed ``w_in``
  and conv gathered under the per-sample ``vmap``), dp-csgp on the
  encoder-decoder, BEER on the hybrid;
* the replicated leaves bitwise across the model ranks of an agent in
  every state buffer, and dp-csgp's push-sum weights too;
* the census per axis within the executor's budget;
* the encoder-decoder's frames: the agent's one-card rows on each of its
  model ranks, bitwise.
"""

import numpy as np
import pytest
import torch
from torch.func import grad_and_value

import torch_tp_worker as W
from lm_parity import flat
from repro_torch.models import build_model
from repro_torch.nn.module import leaf_specs
from repro_torch.tree import tree_map
from test_torch_tp_families import inputs, reference, spawn

LABELS = list(W.RECURRENT)
# (name, label, variant, gossip, wire, schedule, compressor, rounds)
VARIANTS = (
    ("rwkv6 dp", "rwkv6", "dp", "ring", "dense", None, "top_k", 1),
    ("hybrid dp", "hybrid", "dp", "ring", "dense", None, "top_k", 1),
    ("encdec csgp", "encdec", "csgp", "ring", "dense", None, "block_top_k",
     1),
    ("hybrid beer", "hybrid", "beer", "ring", "dense", None, "top_k", 1),
)
ONE_ROUND = LABELS + [v[0] for v in VARIANTS]


def spawn_recurrent(model, variants, seed=0):
    """Every label's gradient, PORTER-GC (ring, shard-local
    ``block_top_k``) for each, then ``variants``, on ``model`` ranks an
    agent."""
    gc = tuple((label, label, "gc", "ring", "dense", None, "block_top_k", 1)
               for label in LABELS)
    return spawn(model, [], gc + tuple(variants), seed=seed, labels=LABELS,
                 fn=W.recurrent_cases)


def check_recurrent(ranks, model, label, seed=0):
    """Every rank's loss within 1e-5 of the reference's, its agent's
    assembled gradient within 1e-5 of the reference's normwise a leaf and
    of the one-card port's in each leaf's largest difference over its
    largest magnitude."""
    np_params, np_batch = inputs(label, seed)
    want_loss, want = reference(label, np_params, np_batch)
    cfg = W.family_cfg(label)
    one, _ = grad_and_value(build_model(cfg, device="cpu").loss)(
        tree_map(torch.from_numpy, np_params),
        {k: torch.from_numpy(v) for k, v in np_batch.items()})
    one = {k: v.numpy() for k, v in flat(one).items()}
    specs = flat(leaf_specs(build_model(cfg, device="cpu")))
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
            norm = float(np.linalg.norm(got - want[path])
                         / np.linalg.norm(want[path]))
            assert norm <= 1e-5, (label, path, norm)
            err = float(np.abs(got - one[path]).max())
            scale = float(np.abs(one[path]).max())
            assert err <= 1e-5 * scale, (label, path, err, scale)


@pytest.fixture(scope="module")
def ranks():
    return spawn_recurrent(2, VARIANTS)


@pytest.mark.parametrize("label", LABELS)
def test_loss_and_grads_are_the_reference(ranks, label):
    check_recurrent(ranks, 2, label)


@pytest.mark.parametrize("case", ONE_ROUND)
def test_one_round_within_1e6_of_one_process(ranks, case):
    for rank in ranks:
        assert rank[case]["finite"]
        assert rank[case]["x_diff"] <= 1e-6, rank[case]["x_diff"]


@pytest.mark.parametrize("case", ONE_ROUND)
def test_replicated_leaves_are_bitwise_across_model_ranks(ranks, case):
    for rank in ranks:
        assert rank[case]["replicated"]


def test_push_sum_weights_are_bitwise_across_model_ranks(ranks):
    for rank in ranks:
        assert rank["encdec csgp"]["weights_bitwise"]
        assert rank["encdec csgp"]["xw_diff"] <= 1e-6


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


def test_frames_are_the_agents_one_card_rows_on_every_model_rank(ranks):
    for rank in ranks:
        got = rank["frames"]
        assert got["rows"] == {"frames": True, "tokens": True}, got
        assert got["same_on_model_ranks"]
        assert got["shapes"]["frames"] == (1, W.BATCH, W.SEQ, 64)

"""Every decentralized algorithm, ``remat_policy`` and the qsgd wire codec on
the model axis: a ``(data 2, model 2)`` grid of 4 gloo ranks on the CPU
against the port on all agents in one process (its twin: the per-shard
compressor or codec round trip on every agent's whole leaves).

The ranks run ``tests/torch_tp_worker.py::algo_cases`` (one spawn for the
module, one CPU thread a rank), on the tinyllama smoke config in f32,
through ``api.build(spec, bundle.loss, group=, leaf_specs=)``.  Held here:

* one round of dsgd (smooth clip at tau 1; also ``dp=True`` at sigma_p
  0.01 with the one-card noise injected), choco (f32 and bf16 planes),
  subgrad-comp (piecewise clip), porter-adam (f32 and bf16 planes) and
  clip21 on the ring with the shard-local ``block_top_k``; choco with the whole-leaf top_k, qsgd
  and random_k; the qsgd codec at 7 levels under PORTER-GC (packed),
  choco (ring) and dp-csgp (packed, ``exchange_ps``): the gathered x and
  every state buffer within 1e-6 of the one-process round (a bf16 buffer
  within 1e-4: one bf16 ulp may flip where the f32 gradient's last bits
  move its stochastic rounding).  porter-adam's
  x is the exception: Adam's first step moves an element by ``eta * v /
  (|v| + eps)``, so where |v| is ~1e-9 (a leaf's max ~5e-3) the tensor-
  parallel gradient's last-bit differences move x by up to ~1e-3; its
  free round is held on v, m and s, its x normwise (within ADAM_X_REL,
  a planted unchanged replica beyond it) and on the forced round;
* every algorithm's first round forced with the one-card gradient (its
  block on each rank): x bitwise the one-process round's;
* the replicated leaves bitwise across an agent's model ranks in every
  parameter-shaped buffer (porter-adam's ``m`` / ``s`` and clip21's
  ``g_est`` included), and those extra planes at the rank's shard shapes;
* every rank's metrics the one-process metrics (loss and sums within 1e-6
  relative, the wire bytes exactly on the dense wire);
* the census per axis within the executor's budget;
* ``ef_gossip`` on per-shard planes bitwise the one-card planes, f32 and
  bf16;
* the cross-shard clip in every mode (smooth, piecewise, none): the
  factors within 1e-6 of the one-card factors (smooth bitwise), a planted
  shard-local norm far out; clip21's residual norms and ``g_est``
  likewise, ``g_est`` bitwise where the factor is 1;
* ``remat_policy`` "full" and "dots" around the tensor-parallel loss: the
  vmapped and the per-sample gradients and whole PORTER-GC / PORTER-DP
  rounds bitwise the ones without remat, the model-axis census up by
  exactly the forward's collectives, the agent-axis census unchanged,
  "dots" replaying the forward's products;
* the qsgd codec's per-shard draw: each process executor's ``c`` bitwise
  the one-card twin's block, with the global draw injected and drawn from
  the same generator, ``exchange_ps`` too; the reference's draw layout
  (every shard of an agent with the agent's draw) planted and caught.

Without a spawn: the refusals that stay (dp-sgd, soteriafl, fleet) and
the per-shard qsgd round trip
against the reference's ``qsgd_pack_ref`` / ``qsgd_unpack_ref`` on the
same uniforms.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker as W
from repro.core import wire_formats as JWF
from repro_torch import api
from repro_torch.core import wire_formats as WF
from repro_torch.core.agents import model_shard
from repro_torch.launch import mesh, steps
from repro_torch.models import build_model
from repro_torch.nn.module import leaf_specs
from repro_torch.tree import tree_leaves, tree_map

LABELS = list(W.ALGO_RUNS)
ADAM = ("porter-adam", "porter-adam-bf16")
# a free round's buffers: 1e-6 in f32; under bf16 planes a stored bf16
# value may sit one bf16 ulp off (7.6e-6 at 1e-3) where the f32 gradient's
# last bits move its stochastic rounding, so 1e-4, the limit
# tests/test_torch_tp_train.py holds bf16 rounds to
FIELD_TOL = {label: 1e-4 if W.ALGO_RUNS[label][1].get("plane") == "bf16"
             else 1e-6 for label in LABELS}
FREE_X = [label for label in LABELS if label not in ADAM]
# porter-adam's free x, normwise: the sound round reads 2.4e-5 (f32) and
# 3.6e-5 (bf16 planes) on the CPU, agent 1's replica left unchanged 0.22
ADAM_X_REL = 1e-3
CODEC = ("gc-qsgd-packed", "choco-qsgd-ring", "csgp-qsgd-packed")
SUMS = ("consensus_x", "consensus_v", "v_norm", "clip_residual")


@pytest.fixture(scope="module")
def ranks():
    return mesh.spawn_agents(W.algo_cases, 4, model=2, device="cpu",
                             threads=1, timeout_s=240)


@pytest.mark.parametrize("label", FREE_X)
def test_one_round_x_within_1e6_of_one_process(ranks, label):
    for rank in ranks:
        got = rank[label]
        assert got["finite"]
        assert got["x_diff"] <= 1e-6, got["x_diff"]


@pytest.mark.parametrize("label", LABELS)
def test_every_state_buffer_within_1e6_of_one_process(ranks, label):
    for rank in ranks:
        for field, diff in rank[label]["field_diff"].items():
            if label in ADAM and field == "base.x":
                continue        # Adam's normalisation (module docstring)
            assert diff <= FIELD_TOL[label], (field, diff)


@pytest.mark.parametrize("label", ADAM)
def test_porter_adam_free_x_moves_only_where_v_is_near_zero(ranks, label):
    """The free round's x differs by Adam's amplification alone, on the
    few elements where |v| is near eps: read normwise (||x - x_1p|| /
    ||x_1p||), x lies within ADAM_X_REL of the one-process x, and a
    planted fault (agent 1's replica left unchanged by the round) lies
    beyond it.  With bf16 planes the f32 update's EF operands take
    ``ef_step`` as f32 and the two bf16-bound outputs ``sr_cast``, on the
    rank's shards."""
    for rank in ranks:
        got = rank[label]
        assert got["field_diff"]["base.v"] <= FIELD_TOL[label]
        assert got["x_rel"] <= ADAM_X_REL < got["fault_x_rel"], (
            got["x_rel"], got["fault_x_rel"])


@pytest.mark.parametrize("label", LABELS)
def test_forced_first_round_is_bitwise(ranks, label):
    for rank in ranks:
        forced = rank[label]["forced"]
        assert forced["bitwise"], forced["x_diff"]


@pytest.mark.parametrize("label", LABELS)
def test_replicated_leaves_bitwise_in_every_buffer(ranks, label):
    for rank in ranks:
        assert all(rank[label]["replicated"].values()), rank[label][
            "replicated"]


@pytest.mark.parametrize("label,extra", [("porter-adam", {"m", "s"}),
                                         ("porter-adam-bf16", {"m", "s"}),
                                         ("clip21", {"g_est"})])
def test_extra_planes_have_the_rank_shard_shapes(ranks, label, extra):
    """``porter_adam_init`` / ``clip21_init`` build their planes from the
    rank's shards: every leaf at x's local shape (a sharded leaf's shard,
    a replicated leaf whole)."""
    for rank in ranks:
        got = rank[label]
        assert extra <= set(got["fields"])
        assert got["shapes_ok"]


@pytest.mark.parametrize("label", LABELS)
def test_metrics_are_the_one_process_metrics(ranks, label):
    for rank in ranks:
        one, proc = rank[label]["metrics_one"], rank[label]["metrics_proc"]
        for m1, m2 in zip(one, proc):
            assert set(m1) == set(m2)
            if label not in CODEC:     # the twin ships the dense wire
                assert m2["wire_bytes"] == m1["wire_bytes"]
            for key in ("loss",) + SUMS:
                if key in m1:
                    assert abs(m2[key] - m1[key]) <= 1e-6 * abs(m1[key]), key
    first = ranks[0][label]["metrics_proc"]
    assert all(r[label]["metrics_proc"] == first for r in ranks)


@pytest.mark.parametrize("label", LABELS)
def test_census_per_axis_within_the_budget(ranks, label):
    algo = W.ALGO_RUNS[label][0]
    exchanges = 1 if algo in ("dsgd", "choco", "subgrad-comp") else 2
    for rank in ranks:
        agent, model = rank[label]["census"]
        budget, n_leaves = rank[label]["budget"], rank[label]["n_leaves"]
        for cat, count in agent.items():
            if cat != "all-reduce":
                assert cat in budget
                assert count <= exchanges * budget[cat] * n_leaves
        # the metrics (clip21's residual norm one more)
        assert agent["all-reduce"] == (3 if algo == "clip21" else 2)
        assert model["all-reduce"] >= 2        # the clip, the metrics
        assert set(model) <= {"all-reduce", "all-gather"}


@pytest.mark.parametrize("planes", ["f32", "bf16"])
def test_ef_gossip_on_per_shard_planes_is_bitwise(ranks, planes):
    for rank in ranks:
        assert rank["ef_gossip"][planes]


@pytest.mark.parametrize("mode", ["smooth", "piecewise", "none"])
def test_clip_factors_across_shards_are_the_one_card_factors(ranks, mode):
    for rank in ranks:
        got = rank["clip"][mode]
        assert got["factor"] <= 1e-6 and got["block"] <= 1e-6, got
        if mode == "smooth":
            assert got["factor_bitwise"]
        if mode != "none":      # a factor of 1 has no norm to plant
            assert got["factor_fault"] > 1e-2 and got["fault"] > 1e-2


def test_clip21_residual_norms_and_estimate_across_shards(ranks):
    for rank in ranks:
        got = rank["clip"]["clip21"]
        assert got["norms"] <= 1e-6 and got["est"] <= 1e-6, got
        assert got["norms_fault"] > 1e-2
        if got["factor_one"]:
            assert got["est_bitwise"]
        else:
            assert got["est_fault"] > 1e-2
    # agent 0's residual sits inside tau, agent 1's outside
    assert [r["clip"]["clip21"]["factor_one"] for r in ranks] == [
        True, True, False, False]


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("kind", ["grad", "per_sample", "porter-gc round",
                                  "porter-dp round"])
def test_remat_on_the_grid_is_bitwise_and_reruns_the_forward(ranks, policy,
                                                             kind):
    for rank in ranks:
        got = rank["remat"][f"{policy} {kind}"]
        assert got["bitwise"] and got["agent_same"]
        assert got.get("metrics_same", True)
        forward = rank["remat"]["forward"]
        assert forward["all-reduce"] > 0
        assert got["rise"] == {k: forward.get(k, 0) for k in got["rise"]}
        assert set(got["rise"]) == set(forward)


@pytest.mark.parametrize("kind", ["grad", "per_sample"])
def test_remat_dots_replays_the_forward_products(ranks, kind):
    for rank in ranks:
        replays = rank["remat"][f"dots {kind}"]["replays"]
        assert replays.get("replayed", 0) > 0
        assert replays.get("computed", 0) == 0


@pytest.mark.parametrize("how", ["injected", "drawn"])
@pytest.mark.parametrize("mode", ["ring", "packed"])
def test_qsgd_codec_draws_each_shards_block_of_one_draw(ranks, how, mode):
    for rank in ranks:
        got = rank["codec"][f"{how} {mode}"]
        assert got["c_bitwise"] and got["ps_bitwise"]
        assert got["wc_diff"] <= 1e-6 and got["weight"] == 1.0


def test_unsharded_codec_draw_is_caught(ranks):
    """Every shard of an agent packing with the agent's draw (the
    reference's keys) is not the twin's per-shard draw."""
    assert all(r["codec"]["unsharded_draw_differs"] for r in ranks)


# ---------------------------------------------------------------------------
# without a spawn
# ---------------------------------------------------------------------------

def _fake_group():
    return types.SimpleNamespace(n_agents=2, model_size=2, model_index=0,
                                 index=0, axes=("data",), device="cpu")


@pytest.mark.parametrize("spec", [
    api.ExperimentSpec(algo="dp-sgd", n_agents=2, sigma_p=0.1),
    api.ExperimentSpec(algo="soteriafl", n_agents=2, sigma_p=0.1),
    api.ExperimentSpec(algo="porter-gc", n_agents=2, fleet=True),
], ids=["dp-sgd", "soteriafl", "fleet"])
def test_refusals_that_stay_name_item_12c(spec):
    """The server algorithms and the fleet beside a model axis: once part
    of item 12(c), ROADMAP queue 1 item 20 since they run on an agent grid
    of processes."""
    with pytest.raises(ValueError, match=r"item 20"):
        api.build(spec, lambda p, b: p, device="cpu", group=_fake_group())


def test_per_shard_qsgd_round_trip_is_the_reference_on_each_shard():
    """``steps.codec_on_one_card``'s qsgd round trip at 7 levels on the
    tinyllama smoke config's two agents, M = 2, with an injected global
    draw: every (agent, shard) block bitwise the reference's
    ``qsgd_pack_ref`` / ``qsgd_unpack_ref`` of that shard's windows with
    the same uniforms (drawn by the reference from a key a block and
    handed over through numpy).  Integer entries, whose windows' sums of
    squares are exact in f32, as ``tests/test_torch_wire.py`` takes them
    for a bitwise pack (on other data the two packages' norms may sit an
    ulp apart)."""
    cfg = W.smoke()
    specs = leaf_specs(build_model(cfg, device="cpu"))
    n, model = 2, 2
    rng = np.random.default_rng(60)
    tree = tree_map(lambda s: torch.from_numpy(rng.integers(
        -3, 4, (n,) + s.shape).astype(np.float32)), specs)
    leaves, spec_leaves = tree_leaves(tree), tree_leaves(specs)
    blocks, want = [], []
    for li, (leaf, s) in enumerate(zip(leaves, spec_leaves)):
        k = 1 if s.model_dim is None else model
        for i in range(n):
            for m in range(k):
                part = leaf[i] if k == 1 else model_shard(
                    leaf[i], s.model_dim, m, model)
                rows = WF.to_windows(part.reshape(-1)).numpy()
                key = jax.random.fold_in(jax.random.PRNGKey(li), i * k + m)
                u = np.array(jax.random.uniform(key, rows.shape,
                                                jnp.float32))
                blocks.append(torch.from_numpy(u))
                words, scale = JWF.qsgd_pack_ref(key, jnp.asarray(rows), 7)
                back = np.asarray(JWF.qsgd_unpack_ref(words, scale, 7))
                want.append((li, i, m, back.reshape(-1)[:part.numel()]
                             .reshape(part.shape)))
    noise = torch.cat(blocks)
    twin = steps.codec_on_one_card(WF.make_wire_format("qsgd", levels=7),
                                   specs, model)
    got = tree_leaves(twin(None, tree, noise=noise))
    for li, i, m, back in want:
        s = spec_leaves[li]
        part = got[li][i] if s.model_dim is None else model_shard(
            got[li][i], s.model_dim, m, model)
        assert np.array_equal(part.numpy().view(np.int32),
                              back.astype(np.float32).view(np.int32)), (
            li, i, m)

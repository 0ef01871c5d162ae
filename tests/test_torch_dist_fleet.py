"""The fleet axis sharded over processes: n agents over 4 gloo ranks on the
CPU, k = n / 4 agents a rank, against the port's one-card fleet and the
reference's.

The ranks run ``tests/torch_fleet_server_worker.py::fleet_cases`` (one
spawn for the module, one CPU thread a rank).  The cases: the port's form
of ``tests/test_fleet.py``'s ``SHARD_SCRIPT`` (8 agents, 2 a rank,
PORTER-GC on the ring, top_k 0.25, 5 rounds), one agent a rank, PORTER-DP
on a rotating schedule and dp-csgp (its push-sum weight) at 8 agents,
and above the dense gate 1,024 agents (256 a rank, the COO slots of a
rank's rows) on the exponential graph and on ``fleet_er_schedule(period
= 4)`` under PORTER-GC, clip21 and PORTER-DP (the DP noise injected).
Held here:

* bitwise: every rank's block and the gathered state against the one-card
  fleet's; each fleet mixer (dense gate and COO, static and schedule, mix
  and push, f32 and bf16 leaves) against the one-card mixer's rows; the
  block draws (``local_rows``, ``minibatch_source``) against the one-card
  draws' rows;
* the metrics: the loss bitwise, the wire bytes exactly, the sums over
  agents (consensus, norms) within 1e-6 relative, every rank the same;
* the census: one all-gather a mix, as the dense process executor's, and
  the bytes every agent's;
* atol 1e-5 (``SHARD_SCRIPT``'s tolerance): the gathered state of its
  problem against ``repro.api.build(fleet=True)`` on one device, which
  runs while the ranks do;
* the refusals: n that does not divide over the ranks, a fleet beside a
  model axis (item 20).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.api as japi
from repro_torch import api
from repro_torch.launch import mesh

import torch_fleet_server_worker as W

RANKS = 4
CASES = list(W.FLEET_CASES)
REDUCED = ("consensus_x", "consensus_v", "v_norm", "clip_residual")


def _loss_j(params, batch):
    f, l = batch
    f, l = jnp.atleast_2d(f), jnp.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))


def _reference_shard():
    """``SHARD_SCRIPT``'s fleet run on one device: the final state."""
    n, over = W.FLEET_CASES["shard n8 k2"]
    algo = japi.build(japi.ExperimentSpec(n_agents=n, **W.SHARD, **over),
                      _loss_j)
    st = algo.init({"w": jnp.zeros(W.D), "b": jnp.zeros(())})
    batch = tuple(map(jnp.asarray, W.shard_problem()))
    step = jax.jit(algo.step)
    key = jax.random.PRNGKey(0)
    for t in range(W.FLEET_ROUNDS):
        _, ks = jax.random.split(jax.random.fold_in(key, t))
        st, _ = step(st, batch, ks)
    return st


@pytest.fixture(scope="module")
def runs():
    out = {}
    spawn = threading.Thread(target=lambda: out.update(ranks=mesh.spawn_agents(
        W.fleet_cases, RANKS, device="cpu", threads=1, timeout_s=240)))
    spawn.start()
    try:
        reference = _reference_shard()
    finally:
        spawn.join()
    assert "ranks" in out, "the spawn failed (its error is above)"
    return {"ranks": out["ranks"], "reference": reference}


@pytest.mark.parametrize("case", CASES)
def test_fleet_on_processes_is_the_one_card_fleet_bitwise(runs, case):
    n = W.FLEET_CASES[case][0]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[case]
        assert got["rows"] == n // RANKS, r
        assert got["block_bitwise"], r
        assert got["state_bitwise"], r


@pytest.mark.parametrize("case", CASES)
def test_fleet_metrics_are_the_one_card_metrics(runs, case):
    first = runs["ranks"][0][case]["metrics_proc"]
    for rank in runs["ranks"]:
        one, proc = rank[case]["metrics_one"], rank[case]["metrics_proc"]
        assert len(proc) == W.FLEET_ROUNDS
        for t, (a, b) in enumerate(zip(one, proc)):
            assert set(a) == set(b)
            np.testing.assert_array_equal(b["loss"], a["loss"])
            np.testing.assert_array_equal(b["wire_bytes"], a["wire_bytes"])
            for k in REDUCED:
                if k in a:
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-6,
                                               err_msg=k)
            for k, v in b.items():
                np.testing.assert_array_equal(v, first[t][k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_fleet_census_is_the_dense_process_executors(runs, case):
    """One all-gather a mix, as the dense process executor issues (at one
    agent a rank and at k), within the fleet mixer's budget; the last
    mix shipped every agent's bytes (x, and dp-csgp's weight)."""
    n = W.FLEET_CASES[case][0]
    per_agent = 4 * (W.D + 1) + (4 if "dp-csgp" in case else 0)
    for rank in runs["ranks"]:
        got = rank[case]
        assert rank["dense census"] == {"all-gather": 1}
        assert got["budget"] == {"all-gather": 1}
        assert got["census"]["all-gather"] == got["mixes"]
        assert set(got["census"]) <= {"all-gather", "all-reduce"}
        assert got["shipped"] == n * per_agent


def test_shard_script_within_1e5_of_the_reference_fleet(runs):
    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(
        runs["reference"]) if np.ndim(leaf) or leaf.dtype == jnp.float32]
    for r, rank in enumerate(runs["ranks"]):
        got = rank["shard n8 k2"]["gathered"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert rank["shard n8 k2"]["state_bitwise"], r


@pytest.mark.parametrize("kind", W.FLEET_MIXERS)
def test_fleet_mixer_rows_are_the_one_card_rows_bitwise(runs, kind):
    assert all(rank["mixers"][kind] for rank in runs["ranks"])


@pytest.mark.parametrize("site", ["local_rows", "minibatch_source"])
def test_a_ranks_block_draw_is_its_rows_of_the_one_card_draw(runs, site):
    assert all(rank["draws"][site] for rank in runs["ranks"])


def _group(sizes=(4,), axes=("data",)):
    return mesh.AgentGroup(index=0, sizes=sizes, axes=axes, device="cpu",
                           backend="gloo", staged=False)


def test_fleet_refuses_an_agent_count_that_does_not_divide():
    spec = api.ExperimentSpec(n_agents=10, fleet=True)
    with pytest.raises(ValueError, match="does not divide"):
        api.build(spec, W.logreg_loss, device="cpu", group=_group())


def test_fleet_beside_a_model_axis_names_item_20():
    spec = api.ExperimentSpec(n_agents=8, fleet=True)
    with pytest.raises(ValueError, match="item 20"):
        api.build(spec, W.logreg_loss, device="cpu",
                  group=_group((4, 2), ("data", "model")))

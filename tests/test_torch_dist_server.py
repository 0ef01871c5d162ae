"""The server algorithms (DP-SGD, SoteriaFL) with their clients as
processes: 4 gloo ranks on the CPU, one client a rank, against the port
with every client in one process and against ``repro.api.build``.

The ranks run ``tests/torch_fleet_server_worker.py::server_cases`` (one
spawn for the module, one CPU thread a rank) on the Section-5.2 MLP, 5
rounds, the DP noise injected (the reference's N(0, 1) draws of each
round, recomputed here from its round key as ``repro.core.baselines``
splits it).  SoteriaFL runs under top_k and under random_k, whose mask is
injected through ``build(compress_fn=)`` on both packages (and drawn from
the round's generator in one more case, against the one-process port
only).  Held here:

* bitwise: every rank's state against the one-process run's (x, h_bar and
  the rank's row of h); DP-SGD also with its pooled batch in chunks (a
  gather per chunk of a rank's samples);
* bitwise: ``x`` the same on every rank; the loss and the wire bytes of
  every round are the one-process ones;
* the collectives: one all-gather a round (SoteriaFL's uploads, DP-SGD's
  clipped rows), a rank's ``h`` its client's row;
* atol 1e-5 (``tests/test_torch_baselines.py``'s tolerance): every
  round's state on the ranks against the reference's run with the same
  draws (the reference runs while the ranks do);
* the refusals beside a model axis (item 20), and of DP-SGD's forced
  rows without a group.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.models import paper as jpaper
from repro_torch import api
from repro_torch.launch import mesh

import torch_fleet_server_worker as W

N = 4
CASES = list(W.SERVER_CASES)
# the reference takes the injected mask through compress_fn; a drawn mask
# has no reference twin
REF_CASES = [c for c in CASES if "drawn" not in c]
FIELDS = {"dp-sgd": ("x",), "soteriafl": ("x", "h", "h_bar")}


def _round_key(t):
    return jax.random.fold_in(jax.random.PRNGKey(0), t)


def _normal_per_leaf(key, params):
    """The server's (or one client's) DP draws: the key split once per
    gradient leaf, in tree order (``baselines._dp_gradient``)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten([np.asarray(jax.random.normal(
        k, np.shape(leaf), jnp.float32)) for k, leaf in zip(keys, leaves)])


def _noise(algo, key, params):
    if algo == "dp-sgd":
        return _normal_per_leaf(key, params)
    k_g, _ = jax.random.split(key)
    per = [_normal_per_leaf(k, params) for k in jax.random.split(k_g, N)]
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *per)


def _masks(params, frac):
    rng = np.random.default_rng(11)
    return [{k: rng.random((N,) + v.shape) < frac for k, v in params.items()}
            for _ in range(W.SERVER_ROUNDS)]


def _fields(state, algo):
    """A reference state's tree fields as f32 numpy."""
    return {f: {k: np.asarray(v).astype(np.float32)
                for k, v in getattr(state, f).items()}
            for f in FIELDS[algo]}


def _reference(case, batches, params, masks):
    """The reference's states after every round."""
    spec_kw = W.server_spec(case, N)
    algo = spec_kw["algo"]

    def build(m):
        kw = {}
        if m is not None:
            kw["compress_fn"] = lambda key, tree: {
                k: jnp.where(m[k], leaf, jnp.zeros_like(leaf))
                for k, leaf in tree.items()}
        return japi.build(japi.ExperimentSpec(**spec_kw), jpaper.mlp_loss(),
                          **kw)

    step = jax.jit(lambda st, b, k, m: build(m).step(st, b, k))
    state = build(None).init({k: jnp.asarray(v) for k, v in params.items()})
    after = []
    for t in range(W.SERVER_ROUNDS):
        m = None if masks is None else masks[t]
        state, _ = step(state, tuple(map(jnp.asarray, batches[t])),
                        _round_key(t), m)
        after.append(_fields(state, algo))
    return after


@pytest.fixture(scope="module")
def runs():
    """Every rank's reports, and each case's reference states (made while
    the ranks run)."""
    batches, params = W.server_problem(N)
    injected = {}
    for case in CASES:
        over = W.SERVER_CASES[case]
        injected[case] = {
            "noise": [_noise(over["algo"], _round_key(t), params)
                      for t in range(W.SERVER_ROUNDS)],
            "masks": _masks(params, over["frac"]) if "mask" in case else None}
    out = {}
    spawn = threading.Thread(target=lambda: out.update(ranks=mesh.spawn_agents(
        W.server_cases, N, (injected,), device="cpu", threads=1,
        timeout_s=240)))
    spawn.start()
    refs = {}
    try:
        for case in REF_CASES:
            if "chunked" in case:        # the reference does not chunk
                refs[case] = refs["dp-sgd f32"]
            else:
                refs[case] = _reference(case, batches, params,
                                        injected[case]["masks"])
    finally:
        spawn.join()
    assert "ranks" in out, "the spawn failed (its error is above)"
    return {"ranks": out["ranks"], "refs": refs}


@pytest.mark.parametrize("case", CASES)
def test_server_on_processes_is_the_one_process_run_bitwise(runs, case):
    for r, rank in enumerate(runs["ranks"]):
        assert rank[case]["state_bitwise"], r
        if rank[case]["h_rows"] is not None:
            assert rank[case]["h_rows"] == 1           # one client a rank


@pytest.mark.parametrize("case", CASES)
def test_server_x_is_the_same_on_every_rank(runs, case):
    first = runs["ranks"][0][case]["x"]
    for rank in runs["ranks"][1:]:
        for k, v in rank[case]["x"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_server_loss_and_wire_bytes_are_the_one_process_ones(runs, case):
    for rank in runs["ranks"]:
        one, proc = rank[case]["metrics_one"], rank[case]["metrics_proc"]
        assert len(proc) == W.SERVER_ROUNDS
        for a, b in zip(one, proc):
            assert set(a) == set(b) == {"loss", "wire_bytes"}
            np.testing.assert_array_equal(b["loss"], a["loss"])
            np.testing.assert_array_equal(b["wire_bytes"], a["wire_bytes"])


@pytest.mark.parametrize("case", CASES)
def test_server_round_is_one_all_gather(runs, case):
    """SoteriaFL's uploads and losses cross in one all-gather a round, as
    do DP-SGD's clipped rows; chunked, one a chunk of a rank's samples (4
    ranks x chunks of 3, 3 and 2)."""
    per_round = 12 if "chunked" in case else 1
    for rank in runs["ranks"]:
        assert rank[case]["census"] == {
            "all-gather": per_round * W.SERVER_ROUNDS}


@pytest.mark.parametrize("case", REF_CASES)
def test_server_rounds_within_1e5_of_the_reference(runs, case):
    want = runs["refs"][case]
    for r, rank in enumerate(runs["ranks"]):
        for t, got in enumerate(rank[case]["states"]):
            for field, ref in want[t].items():
                for k, v in got[field].items():
                    np.testing.assert_allclose(
                        v, ref[k][r:r + 1] if field == "h" else ref[k],
                        rtol=0, atol=1e-5,
                        err_msg=f"rank {r} round {t} {field}[{k}]")


def _model_group():
    return mesh.AgentGroup(index=0, sizes=(4, 2), axes=("data", "model"),
                           device="cpu", backend="gloo", staged=False)


@pytest.mark.parametrize("algo", ["dp-sgd", "soteriafl"])
def test_server_algorithm_beside_a_model_axis_names_item_20(algo):
    spec = api.ExperimentSpec(algo=algo, n_agents=4)
    with pytest.raises(ValueError, match="item 20"):
        api.build(spec, W.logreg_loss, device="cpu", group=_model_group())


def test_dp_sgd_forced_rows_need_the_clients_group():
    spec = api.ExperimentSpec(algo="dp-sgd", n_agents=N, sigma_p=0.1)
    algo = api.build(spec, W.logreg_loss, device="cpu")
    state = algo.init({"w": torch.zeros(3), "b": torch.zeros(())})
    batch = (torch.zeros(N, 2, 3), torch.zeros(N, 2))
    with pytest.raises(ValueError, match="clients' group"):
        algo.step(state, batch, None,
                  clipped=(torch.zeros(2, 8192), torch.zeros(2)))

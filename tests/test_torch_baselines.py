"""The paper's baselines (DSGD, CHOCO-SGD, DP-SGD, SoteriaFL) through the
port's entry points against ``repro.core.baselines`` on the CPU.

Section-5.1 logistic regression (d = 124 per agent), 10 agents on the
paper's ER(0.8) graph, top-k 5 %.  Both packages see the same batches
(numpy indices); the DP algorithms are handed the reference's N(0, 1)
draws, recomputed here from the reference's round key exactly as
``repro.core.baselines`` splits it.

Tolerances: teacher-forced, atol 1e-5 -- from every reference state one
port step must land on the next reference state; what differs is the f32
rounding of gradients, of the mean over agents and of the W @ x product
(summation order), as in ``tests/test_torch_porter.py``.  The port's own
invariants (kernel backend vs ref backend) are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import comm_round as JCR
from repro.core import compression as JCMP
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import comm_round as TCR
from repro_torch.core import compression as TCMP
from repro_torch.data import a9a_like, minibatch_source, shard_to_agents
from repro_torch.kernels import ops
from repro_torch.launch.runtime import run_chunked

torch.set_num_threads(1)

N_AGENTS, ROUNDS, BATCH = 10, 12, 8
PAPER_GRAPH = dict(n_agents=N_AGENTS, topology="erdos_renyi",
                   topology_weights="best_constant", topology_p=0.8,
                   topology_seed=1, compressor="top_k", frac=0.05)
SIGMA_P = 0.05
# algorithm -> (spec overrides, state fields that hold trees)
CASES = {
    "dsgd": (dict(eta=0.05, tau=1.0), ("x",)),
    "dsgd-dp": (dict(algo="dsgd", eta=0.05, tau=1.0, dp=True,
                     sigma_p=SIGMA_P), ("x",)),
    "choco": (dict(eta=0.05, tau=1.0), ("x", "q", "m")),
    "dp-sgd": (dict(eta=0.05, tau=1.0, sigma_p=SIGMA_P), ("x",)),
    "soteriafl": (dict(eta=0.05, tau=1.0, sigma_p=SIGMA_P, alpha_shift=0.5),
                  ("x", "h", "h_bar")),
}


def logreg_loss_j(params, batch):
    f, l = batch
    f, l = jnp.atleast_2d(f), jnp.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    nll = jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))
    return nll + 0.2 * jnp.sum(params["w"] ** 2 / (1 + params["w"] ** 2))


def logreg_loss_t(params, batch):
    f, l = batch
    f, l = torch.atleast_2d(f), torch.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    nll = torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))
    return nll + 0.2 * torch.sum(params["w"] ** 2 / (1 + params["w"] ** 2))


def _problem():
    x, y = a9a_like(num=4000, dim=123, seed=0)
    xs, ys = shard_to_agents(x, y, N_AGENTS)
    rng = np.random.default_rng(1)
    params = {"w": (0.1 * rng.standard_normal(123)).astype(np.float32),
              "b": np.float32(0.0)}
    return params, (xs, ys)


def _batches(data, rounds, seed=3):
    xs, ys = data
    rng = np.random.default_rng(seed)
    rows = np.arange(N_AGENTS)[:, None]
    out = []
    for _ in range(rounds):
        idx = rng.integers(0, xs.shape[1], (N_AGENTS, BATCH))
        out.append((xs[rows, idx], ys[rows, idx]))
    return out


def _round_key(t):
    return jax.random.fold_in(jax.random.PRNGKey(0), t)


def _normal_per_leaf(key, params):
    """One agent's (or the server's) DP draws: the key split once per
    gradient leaf, in tree order (``baselines._dp_gradient``)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten([np.asarray(jax.random.normal(
        k, np.shape(leaf), jnp.float32)) for k, leaf in zip(keys, leaves)])


def _stacked_normal(agent_keys, params):
    per_agent = [_normal_per_leaf(k, params) for k in agent_keys]
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *per_agent)


def reference_noise(case, key, params):
    """The N(0, 1) draws the reference's step makes from round key ``key``."""
    if case == "dsgd-dp":
        return _stacked_normal(jax.random.split(key, N_AGENTS), params)
    if case == "dp-sgd":
        return _normal_per_leaf(key, params)
    if case == "soteriafl":
        k_g, _ = jax.random.split(key)
        return _stacked_normal(jax.random.split(k_g, N_AGENTS), params)
    return None


def _spec_kw(case):
    over, _ = CASES[case]
    return dict(PAPER_GRAPH, **dict(dict(algo=case), **over))


@functools.lru_cache(maxsize=None)
def reference_trajectory(case):
    params, data = _problem()
    ralgo = japi.build(japi.ExperimentSpec(**_spec_kw(case)), logreg_loss_j)
    step = jax.jit(ralgo.step)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params))
    batches = _batches(data, ROUNDS)
    states, metrics = [state], []
    for t, batch in enumerate(batches):
        state, met = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                          _round_key(t))
        states.append(state)
        metrics.append({k: float(v) for k, v in met.items()})
    noise = [reference_noise(case, _round_key(t), params)
             for t in range(ROUNDS)]
    return states, metrics, batches, noise, params, ralgo.gamma


def _port(case, **over):
    spec = tapi.ExperimentSpec(**dict(_spec_kw(case), **over))
    return tapi.build(spec, logreg_loss_t, device="cpu")


def _assert_state(port_state, ref_state, fields, atol):
    for field in fields:
        got, want = getattr(port_state, field), getattr(ref_state, field)
        for k in want:
            np.testing.assert_allclose(
                convert.to_numpy(got[k]), np.asarray(want[k]), rtol=0,
                atol=atol, err_msg=f"{field}[{k}]")


@pytest.mark.parametrize("case", sorted(CASES))
def test_teacher_forced_steps_equal_reference(case):
    states, metrics, batches, noise, _, gamma = reference_trajectory(case)
    talgo = _port(case)
    assert talgo.gamma == gamma
    fields = CASES[case][1]
    for t in range(ROUNDS):
        state = convert.state_to_torch(states[t], "cpu")
        kw = {} if noise[t] is None else {"noise": convert.to_torch(
            noise[t], "cpu")}
        new, met = talgo.step(state, convert.to_torch(batches[t], "cpu"),
                              None, **kw)
        assert new.step == t + 1
        _assert_state(new, states[t + 1], fields, atol=1e-5)
        assert set(met) == set(metrics[t])
        for name in met:
            np.testing.assert_allclose(float(met[name]), metrics[t][name],
                                       rtol=0, atol=1e-5, err_msg=name)


INITS = [(case, None) for case in sorted(CASES)] + [("choco", "bf16"),
                                                    ("soteriafl", "bf16")]


@pytest.mark.parametrize("case,plane", INITS)
def test_init_equals_reference(case, plane):
    params, _ = _problem()
    over = {} if plane is None else {"plane_dtype": plane}
    want = japi.build(japi.ExperimentSpec(**dict(_spec_kw(case), **over)),
                      logreg_loss_j).init(
        jax.tree_util.tree_map(jnp.asarray, params))
    got = _port(case, **over).init(convert.to_torch(params, "cpu"))
    assert type(got).__name__ == type(want).__name__ and got.step == 0
    for field in CASES[case][1]:
        for k, leaf in getattr(want, field).items():
            mine = getattr(got, field)[k]
            bf16 = leaf.dtype == jnp.bfloat16
            assert mine.dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_array_equal(
                convert.to_numpy(mine),
                np.asarray(leaf).view(np.uint16) if bf16 else np.asarray(leaf))


def test_state_bridge_round_trips_every_baseline_state():
    for case in ("dsgd", "choco", "dp-sgd", "soteriafl"):
        states = reference_trajectory(case)[0]
        port = convert.state_to_torch(states[3], "cpu")
        back = convert.state_to_numpy(port)
        assert type(back).__name__ == type(states[3]).__name__
        assert back.step == 3
        for field in CASES[case][1]:
            for k, leaf in getattr(states[3], field).items():
                np.testing.assert_array_equal(getattr(back, field)[k],
                                              np.asarray(leaf))


# ---------------------------------------------------------------------------
# the port's own invariants (exact)
# ---------------------------------------------------------------------------

def _port_run(algo, steps, chunk, seed=5, **over):
    spec = tapi.ExperimentSpec(**dict(PAPER_GRAPH, algo=algo, eta=0.05,
                                      tau=1.0, sigma_p=SIGMA_P,
                                      compressor="random_k", frac=0.2,
                                      **over))
    talgo = tapi.build(spec, logreg_loss_t, device="cpu")
    params, data = _problem()
    source = minibatch_source(*data, batch=BATCH, device="cpu")
    state = talgo.init(convert.to_torch(params, "cpu"))
    mets = []
    state, _ = run_chunked(talgo, source, state, seed, steps, chunk=chunk,
                           on_chunk=lambda t0, t1, s, m: mets.append(m))
    return state, {k: torch.cat([m[k] for m in mets]) for k in mets[0]}


@pytest.mark.parametrize("plane", [None, "bf16"])
def test_choco_kernel_backend_equals_ref_backend_exactly(plane):
    """ef_gossip over planes (its plain version on the CPU) and the leafwise
    round give the same bits, with the SR writeback under bf16: both read
    the one plane of random words the round draws."""
    ops.reset_launches()
    (sk, mk), (sr, mr) = (
        _port_run("choco", 6, 3, comm_backend=b, plane_dtype=plane)
        for b in ("kernel", "ref"))
    for field in ("x", "q", "m"):
        for k, leaf in getattr(sk, field).items():
            assert torch.equal(leaf, getattr(sr, field)[k]), (field, k)
    for k in mk:
        assert torch.equal(mk[k], mr[k]), k
    assert set(ops.LAUNCHES.values()) == {0}
    if plane:
        assert sk.q["w"].dtype == torch.bfloat16
        assert sk.x["w"].dtype == torch.float32


@pytest.mark.parametrize("algo", ["dsgd", "dp-sgd", "soteriafl", "choco"])
def test_chunking_does_not_change_baseline_trajectories(algo):
    """Round t's generators are a pure function of (seed, t), for the
    baselines' DP noise and random-k masks too."""
    one, _ = _port_run(algo, 6, 1)
    other, _ = _port_run(algo, 6, 4)
    assert torch.equal(one.x["w"], other.x["w"])


def test_dp_sgd_rejects_unstacked_batches():
    talgo = _port("dp-sgd")
    params, data = _problem()
    state = talgo.init(convert.to_torch(params, "cpu"))
    flat = (torch.zeros(5, 123), torch.zeros(5))
    with pytest.raises(ValueError, match="agent-stacked"):
        talgo.step(state, flat, None)


@pytest.mark.parametrize("mode", ["dense", "ring", "packed"])
@pytest.mark.parametrize("plane", [None, "bf16"])
def test_wire_bytes_follow_the_plane_width(mode, plane):
    """Ring and packed byte models ship values at the plane dtype's width;
    the dense model charges the compressor's own payload either way."""
    def tagged(fn):
        fn.wire_mode = mode
        return fn

    jeng = JCR.CommRound(JCMP.top_k(0.05), tagged(lambda t: t),
                         plane_dtype=None if plane is None else jnp.bfloat16)
    teng = TCR.CommRound(TCMP.top_k(0.05), tagged(lambda t: t),
                         plane_dtype=None if plane is None else torch.bfloat16)
    for d in (124, 50890):
        assert teng.wire_bytes(d, N_AGENTS) == jeng.wire_bytes(d, N_AGENTS)

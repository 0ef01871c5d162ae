"""The slice as a whole: PORTER-GC, PORTER-DP and BEER through the port's
entry points (``build`` -> ``init`` -> ``step`` / ``run_chunked``) against
the JAX reference on the CPU.

Two models: the Section-5.1 logistic regression at its published width
(d = 124 per agent) and the Section-5.2 MLP cut to 32 -> 8 -> 10, with the
same parameters carried into both packages through ``repro_torch.convert``.
Both packages see the same batches (numpy indices); for PORTER-DP the port
is handed the reference's N(0, 1) draws, recomputed here from the
reference's round key exactly as ``repro.core.porter`` splits it.

Tolerances, each with its reason:

* teacher-forced, atol 1e-5: from every reference state along a trajectory
  one port step must land on the next reference state.  Top-k then sees
  identical inputs; what differs is the f32 rounding of gradients and of
  the W @ c product (summation order), as in the reference's own engine
  parity tests;
* free-running, atol 1e-4 on x: 50 rounds from the same start, where those
  rounding differences compound;
* exact: overlap vs sequential order, chunk 1 vs chunk 7, and the port's
  kernel backend (flat planes) vs its ref backend (leafwise).

PORTER-GC also runs with the ``block_top_k`` compressor (per-2048-window
top-k, the reference LM launchers' default), which goes through
``ops.block_topk``; the reference selects with ``jax.lax.top_k``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.models import paper as jpaper
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import average_params
from repro_torch.data import a9a_like, minibatch_source, shard_to_agents
from repro_torch.launch.runtime import run_chunked
from repro_torch.models import paper as tpaper

torch.set_num_threads(1)

N_AGENTS, ROUNDS, BATCH = 10, 50, 8
FIELDS = ("x", "v", "q_x", "q_v", "g_prev", "m_x", "m_v")
SIGMA_P = 0.05
PAPER_GRAPH = dict(n_agents=N_AGENTS, topology="erdos_renyi",
                   topology_weights="best_constant", topology_p=0.8,
                   topology_seed=1, compressor="top_k", frac=0.05)


# ---------------------------------------------------------------------------
# the two models, written once per framework
# ---------------------------------------------------------------------------

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


def _logreg_problem():
    x, y = a9a_like(num=4000, dim=123, seed=0)
    xs, ys = shard_to_agents(x, y, N_AGENTS)
    rng = np.random.default_rng(1)
    params = {"w": (0.1 * rng.standard_normal(123)).astype(np.float32),
              "b": np.float32(0.0)}
    return (logreg_loss_j, logreg_loss_t), params, (xs, ys)


def _mlp_problem():
    rng = np.random.default_rng(2)
    xs = rng.random((N_AGENTS, 200, 32)).astype(np.float32)
    ys = rng.integers(0, 10, (N_AGENTS, 200)).astype(np.int32)
    params = {"w1": (0.3 * rng.standard_normal((32, 8))).astype(np.float32),
              "c1": np.zeros(8, np.float32),
              "w2": (0.3 * rng.standard_normal((8, 10))).astype(np.float32),
              "c2": np.zeros(10, np.float32)}
    return (jpaper.mlp_loss(), tpaper.mlp_loss()), params, (xs, ys)


PROBLEMS = {"logreg": _logreg_problem, "mlp": _mlp_problem}


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


def reference_noise(key, params):
    """The N(0, 1) draws of the reference's DP perturbation for one round:
    ``porter_step`` splits the round key four ways and gives the second to
    the agents, each of which splits its key once per gradient leaf."""
    _, k_noise, _, _ = jax.random.split(key, 4)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    per_agent = []
    for k_agent in jax.random.split(k_noise, N_AGENTS):
        keys = jax.random.split(k_agent, len(leaves))
        per_agent.append([np.asarray(jax.random.normal(
            k, np.shape(leaf), jnp.float32)) for k, leaf in zip(keys, leaves)])
    return treedef.unflatten([np.stack([a[i] for a in per_agent])
                              for i in range(len(leaves))])


def _spec_kw(algo, compressor="top_k"):
    kw = dict(PAPER_GRAPH, algo=algo, eta=0.05, tau=1.0,
              compressor=compressor)
    if algo == "porter-dp":
        kw["sigma_p"] = SIGMA_P
    if algo == "beer":
        kw.pop("tau")
    return kw


@functools.lru_cache(maxsize=None)
def reference_trajectory(model, algo, compressor="top_k"):
    """``ROUNDS`` reference steps: (states, metrics, batches, noise, params,
    gamma)."""
    (loss_j, _), params, data = PROBLEMS[model]()
    ralgo = japi.build(japi.ExperimentSpec(**_spec_kw(algo, compressor)),
                       loss_j)
    step = jax.jit(ralgo.step)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params))
    batches = _batches(data, ROUNDS)
    states, metrics = [state], []
    for t, batch in enumerate(batches):
        state, met = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                          _round_key(t))
        states.append(state)
        metrics.append({k: float(v) for k, v in met.items()})
    noise = ([reference_noise(_round_key(t), params) for t in range(ROUNDS)]
             if algo == "porter-dp" else [None] * ROUNDS)
    return states, metrics, batches, noise, params, ralgo.gamma


def _port(model, algo, **over):
    (_, loss_t), _, _ = PROBLEMS[model]()
    spec = tapi.ExperimentSpec(**dict(_spec_kw(algo), **over))
    return tapi.build(spec, loss_t, device="cpu")


def _assert_state(port_state, ref_state, atol, fields=FIELDS):
    for field in fields:
        got, want = getattr(port_state, field), getattr(ref_state, field)
        for k in want:
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                err_msg=f"{field}[{k}]")


CASES = [("logreg", "porter-gc"), ("logreg", "porter-dp"),
         ("mlp", "porter-gc"), ("mlp", "porter-dp")]


def _top_k(cases):
    return [pytest.param(model, algo, "top_k", id=f"{model}-{algo}")
            for model, algo in cases]


BLOCK_CASES = [pytest.param(model, "porter-gc", "block_top_k",
                            id=f"{model}-porter-gc-block_top_k")
               for model in ("logreg", "mlp")]


@pytest.mark.parametrize("model,algo,comp",
                         _top_k(CASES + [("logreg", "beer")]) + BLOCK_CASES)
def test_teacher_forced_steps_equal_reference(model, algo, comp):
    states, metrics, batches, noise, _, gamma = reference_trajectory(
        model, algo, comp)
    talgo = _port(model, algo, compressor=comp)
    assert talgo.gamma == gamma
    for t in range(ROUNDS):
        state = convert.state_to_torch(states[t], "cpu")
        kw = {} if noise[t] is None else {"noise": convert.to_torch(
            noise[t], "cpu")}
        new, met = talgo.step(state, convert.to_torch(batches[t], "cpu"),
                              None, **kw)
        assert new.step == t + 1
        _assert_state(new, states[t + 1], atol=1e-5)
        for name in ("loss", "consensus_x", "wire_bytes"):
            np.testing.assert_allclose(float(met[name]), metrics[t][name],
                                       rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("model,algo,comp", _top_k(CASES) + BLOCK_CASES)
def test_free_running_trajectory_equals_reference(model, algo, comp):
    states, _, batches, noise, _, _ = reference_trajectory(model, algo, comp)
    talgo = _port(model, algo, compressor=comp)
    state = convert.state_to_torch(states[0], "cpu")
    for t in range(ROUNDS):
        kw = {} if noise[t] is None else {"noise": convert.to_torch(
            noise[t], "cpu")}
        state, _ = talgo.step(state, convert.to_torch(batches[t], "cpu"),
                              None, **kw)
    _assert_state(state, states[ROUNDS], atol=1e-4, fields=("x",))


def test_init_equals_reference():
    states, _, _, _, params, _ = reference_trajectory("mlp", "porter-gc")
    state = _port("mlp", "porter-gc").init(convert.to_torch(params, "cpu"))
    _assert_state(state, states[0], atol=0.0)
    assert state.step == 0


# ---------------------------------------------------------------------------
# the port's own invariants (exact)
# ---------------------------------------------------------------------------

def _port_run(model, steps, chunk, seed=5, **over):
    talgo = _port(model, "porter-dp", compressor="random_k", **over)
    _, params, data = PROBLEMS[model]()
    source = minibatch_source(*data, batch=BATCH, device="cpu")
    state = talgo.init(convert.to_torch(params, "cpu"))
    mets = []
    state, _ = run_chunked(talgo, source, state, seed, steps, chunk=chunk,
                           on_chunk=lambda t0, t1, s, m: mets.append(m))
    return state, {k: torch.cat([m[k] for m in mets]) for k in mets[0]}


def _assert_equal_runs(a, b):
    (sa, ma), (sb, mb) = a, b
    for field in FIELDS:
        for k, leaf in getattr(sa, field).items():
            assert torch.equal(leaf, getattr(sb, field)[k]), (field, k)
    assert sa.step == sb.step
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_overlap_equals_sequential_exactly():
    """Both exchanges first, then both updates: same values, same draws
    (DP noise and random-k masks from the round's generator)."""
    _assert_equal_runs(_port_run("mlp", 10, 5, overlap=True),
                       _port_run("mlp", 10, 5, overlap=False))


def test_chunking_does_not_change_the_trajectory():
    """Round t's generators are a pure function of (seed, t)."""
    one = _port_run("logreg", 15, 1)
    _assert_equal_runs(one, _port_run("logreg", 15, 7))
    other_seed = _port_run("logreg", 15, 7, seed=6)
    assert not torch.equal(one[0].x["w"], other_seed[0].x["w"])


def test_resume_continues_the_stream():
    talgo = _port("logreg", "porter-dp", compressor="random_k")
    _, params, data = PROBLEMS["logreg"]()
    source = minibatch_source(*data, batch=BATCH, device="cpu")
    init = talgo.init(convert.to_torch(params, "cpu"))
    whole, _ = run_chunked(talgo, source, init, 5, 12, chunk=4)
    half, _ = run_chunked(talgo, source, init, 5, 6, chunk=4)
    resumed, _ = run_chunked(talgo, source, half, 5, 12, chunk=4, start=6)
    for k in whole.x:
        assert torch.equal(whole.x[k], resumed.x[k])


def test_kernel_backend_equals_ref_backend_exactly():
    """The flat-plane path (the plain kernels on the CPU) and the leafwise
    path compute the same f32 operations in the same order."""
    kernel = _port_run("mlp", 12, 6, comm_backend="kernel")
    _assert_equal_runs(kernel, _port_run("mlp", 12, 6, comm_backend="ref"))


def test_quickstart_protocol_passes_its_gate():
    """examples/quickstart.py on the port: Section 5.1, 400 rounds in
    chunks of 50, gradient norm of the average iterate below 0.1."""
    x, y = a9a_like(num=20000, dim=123, seed=0)
    xs, ys = shard_to_agents(x, y, N_AGENTS)
    source = minibatch_source(xs, ys, batch=8, device="cpu")
    talgo = tapi.build(tapi.ExperimentSpec(**dict(
        PAPER_GRAPH, algo="porter-gc", eta=0.05, tau=1.0)), logreg_loss_t,
        device="cpu")
    state = talgo.init({"w": torch.zeros(123), "b": torch.zeros(())})
    state, _ = run_chunked(talgo, source, state, 0, 400, chunk=50)
    avg = {k: v.detach().requires_grad_(True)
           for k, v in average_params(state.x).items()}
    full = (torch.as_tensor(xs.reshape(-1, 123)),
            torch.as_tensor(ys.reshape(-1)))
    grads = torch.autograd.grad(logreg_loss_t(avg, full), list(avg.values()))
    gn = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    assert gn < 0.1

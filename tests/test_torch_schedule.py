"""Time-varying and directed topology schedules in the port
(``repro_torch.core.mixing``, the schedule tables of ``core.gossip``,
``api.resolve_schedule``) against the JAX reference on the CPU.

Tolerances, each with its reason:

* exact: every ``(period, n, n)`` table and adjacency stack
  (``np.array_equal``: the same numpy code draws from the same numpy
  ``Generator`` in the same order), kinds, periods, gammas, the refusals'
  messages, and the port's own invariants (a period-1 schedule against
  the static topology, chunking, the kernel backend against the ref one);
* 1e-12: alpha, the per-round alphas, spectral_gap and joint_spectral_gap
  (one eigensolve or SVD of the same f64 matrix; an ARPACK run above the
  dense gate);
* atol 1e-5: one PORTER-GC step from every reference state (teacher
  forced) and 20 free-running rounds on an ``erdos_renyi`` schedule: top-k
  sees the same inputs, the gradients and ``W_t @ c`` are f32 sums in
  another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import gossip as JG
from repro.core import mixing as JM
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import gossip as TG
from repro_torch.core import mixing as TM
from repro_torch.data import minibatch_source
from repro_torch.launch.runtime import run_chunked
from test_torch_porter import PROBLEMS, _assert_state, _batches, _round_key

torch.set_num_threads(1)

N = 6

# one build per generator kind (and the static wrapper), both directions,
# and one of each direction above the dense-validation gate
GEN_CASES = {
    "static": lambda mx, n=N: mx.make_schedule(
        "static", n, topology=mx.make_topology("erdos_renyi", n, p=0.8,
                                               seed=1)),
    "rotate": lambda mx, n=N: mx.make_schedule(
        "rotate", n, kinds=["ring", "star/lazy", "complete"]),
    "erdos_renyi": lambda mx, n=N: mx.make_schedule(
        "erdos_renyi", n, p=0.7, period=4, seed=1),
    "dropout": lambda mx, n=N: mx.make_schedule(
        "dropout", n, rate=0.3, period=6, base="ring", seed=0),
    "straggler": lambda mx, n=N: mx.make_schedule(
        "straggler", n, rate=0.4, period=6, base="erdos_renyi", p=0.7,
        seed=2),
    "ring_skips": lambda mx, n=N: mx.make_schedule("ring_skips", n, skip=2),
    "digraph": lambda mx, n=N: mx.make_schedule(
        "digraph", n, p=0.5, period=4, seed=3),
    "one_way": lambda mx, n=N: mx.make_schedule(
        "one_way", n, rate=0.3, period=4, skip=2, seed=0),
    "erdos_renyi_above_gate": lambda mx: mx.make_schedule(
        "erdos_renyi", 300, p=0.05, period=2, seed=4),
    "ring_skips_above_gate": lambda mx: mx.make_schedule(
        "ring_skips", 300, skip=7),
}


def _assert_same_schedule(got, want):
    assert (got.kind, got.n, got.period, got.stochasticity,
            got.is_directed) == (want.kind, want.n, want.period,
                                 want.stochasticity, want.is_directed)
    assert np.array_equal(got.ws, want.ws)
    assert np.array_equal(got.adjacencies, want.adjacencies)
    assert np.array_equal(got.window_union(), want.window_union())
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=0, atol=1e-12)
    for name in ("alpha", "joint_alpha", "spectral_gap",
                 "joint_spectral_gap"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-12, err_msg=name)
    for t in range(2 * got.period + 1):
        assert np.array_equal(got.at(t), want.at(t))


@pytest.mark.parametrize("kind", sorted(GEN_CASES))
def test_schedule_tables_equal_reference(kind):
    _assert_same_schedule(GEN_CASES[kind](TM), GEN_CASES[kind](JM))


def test_generator_registry_equals_reference():
    assert TM.SCHEDULE_STOCHASTICITY == JM.SCHEDULE_STOCHASTICITY
    assert set(TM._SCHEDULE_GENERATORS) == set(JM._SCHEDULE_GENERATORS)
    assert TM.VALIDATE_DENSE_GATE == JM.VALIDATE_DENSE_GATE
    assert {k.split("_above")[0] for k in GEN_CASES} == (
        set(TM.SCHEDULE_STOCHASTICITY) | {"static"})


@pytest.mark.parametrize("fn", ["mixing_rate_power", "joint_window_alpha",
                                "joint_window_contraction",
                                "contraction_factor", "union_connected"])
def test_validators_equal_reference(fn):
    sched = GEN_CASES["dropout"](JM)
    directed = GEN_CASES["one_way"](JM)
    calls = {
        "mixing_rate_power": lambda mx: [mx.mixing_rate_power(w)
                                         for w in sched.ws],
        "joint_window_alpha": lambda mx: [
            mx.joint_window_alpha(sched.ws, method=m)
            for m in ("dense", "power")],
        "joint_window_contraction": lambda mx: [
            mx.joint_window_contraction(directed.ws, method=m)
            for m in ("dense", "power")],
        "contraction_factor": lambda mx: [mx.contraction_factor(w)
                                          for w in directed.ws],
        "union_connected": lambda mx: [
            mx.union_connected(sched.adjacencies),
            mx.union_connected(directed.adjacencies, directed=True),
            mx.union_connected(directed.adjacencies[:1], directed=True)],
    }
    np.testing.assert_allclose(calls[fn](TM), calls[fn](JM), rtol=0,
                               atol=1e-12)


BAD_GENERATORS = {
    "best_constant_churn": lambda mx: mx.dropout_schedule(
        N, weights="best_constant"),
    "dropout_rate": lambda mx: mx.dropout_schedule(N, rate=1.0),
    "straggler_rate": lambda mx: mx.straggler_schedule(N, rate=-0.1),
    "er_period": lambda mx: mx.erdos_renyi_schedule(N, period=0),
    "empty_rotate": lambda mx: mx.rotating_schedule([], N),
    "disconnected_rotate": lambda mx: mx.make_schedule(
        "rotate", N, kinds=["erdos_renyi"], p=0.0),
    "skip": lambda mx: mx.directed_ring_graph(N, skip=1),
    "digraph_p": lambda mx: mx.random_digraph_schedule(N, p=0.0),
    "one_way_rate": lambda mx: mx.directed_churn_schedule(N, rate=1.0),
    "unknown_kind": lambda mx: mx.make_schedule("spiral", N),
    "static_without_topology": lambda mx: mx.make_schedule("static", N),
}


@pytest.mark.parametrize("case", sorted(BAD_GENERATORS))
def test_generator_refusals_are_the_reference_refusals(case):
    with pytest.raises((ValueError, RuntimeError)) as want:
        BAD_GENERATORS[case](JM)
    with pytest.raises(want.type) as got:
        BAD_GENERATORS[case](TM)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the facade: the reference's string grammar
# ---------------------------------------------------------------------------

SCHEDULE_STRINGS = [
    "static",
    "rotate:ring+star+complete",
    "rotate:ring/metropolis+ring/lazy",
    "rotate:ring+star,weights=lazy",
    "rotate:kinds=ring+star,seed=3",
    "erdos_renyi:period=8,p=0.6",
    "erdos_renyi:period=3,p=0.7",
    "erdos_renyi",
    "dropout:rate=0.2,period=8",
    "dropout:rate=0.3,period=5,base=erdos_renyi,p=0.9,seed=2",
    "straggler:rate=0.3,period=8",
    "straggler:rate=0.2,period=4,base=complete",
    "directed:ring_skips,skip=2",
    "directed:ring_skips",
    "directed:digraph,p=0.5,period=8",
    "directed:one_way,rate=0.2,period=8",
    "directed:one_way,rate=0.2,period=4,skip=3,seed=1",
]


def _specs(text, **over):
    kw = dict(dict(n_agents=N, topology="ring", topology_p=0.8,
                   topology_seed=0, topology_schedule=text), **over)
    return tapi.ExperimentSpec(**kw), japi.ExperimentSpec(**kw)


@pytest.mark.parametrize("text", SCHEDULE_STRINGS)
def test_resolve_schedule_equals_reference(text):
    tspec, jspec = _specs(text)
    _assert_same_schedule(tapi.resolve_schedule(tspec),
                          japi.resolve_schedule(jspec))


def test_no_schedule_resolves_to_none_and_static_takes_the_override():
    tspec, jspec = _specs(None)
    assert tapi.resolve_schedule(tspec) is japi.resolve_schedule(jspec) is None
    tspec, jspec = _specs("static")
    top = TM.make_topology("star", N)
    _assert_same_schedule(tapi.resolve_schedule(tspec, top),
                          japi.resolve_schedule(jspec,
                                                JM.make_topology("star", N)))


BAD_STRINGS = ["warp:speed=9", "dropout:rte=0.3", "dropout:0.3",
               "static:period=2", "rotate:", "rotate:weights=lazy",
               "directed:spiral", "directed:one_way,rte=0.2",
               "directed:", "directed:skip=2",
               "erdos_renyi:period=2,degree=3"]


@pytest.mark.parametrize("text", BAD_STRINGS)
def test_resolve_schedule_errors_are_the_reference_errors(text):
    tspec, jspec = _specs(text)
    with pytest.raises(ValueError) as want:
        japi.resolve_schedule(jspec)
    with pytest.raises(ValueError) as got:
        tapi.resolve_schedule(tspec)
    assert str(got.value) == str(want.value)


def _loss_t(params, batch):
    return torch.sum(params["w"]) * 0.0


def _loss_j(params, batch):
    return jnp.sum(params["w"]) * 0.0


DOUBLY_ALGOS = sorted(set(japi.list_algorithms()) - {"dp-csgp"})


@pytest.mark.parametrize("algo", DOUBLY_ALGOS)
def test_directed_schedule_is_refused_as_the_reference_refuses(algo):
    """Every decentralized algorithm but dp-csgp refuses a directed
    schedule with the reference's message; the server / client ones have
    no graph and build, as in the reference."""
    text = "directed:one_way,rate=0.2,period=4"
    tspec, jspec = _specs(text, algo=algo, compressor="top_k", frac=0.25)
    if not japi.algorithm_info(algo).decentralized:
        assert tapi.build(tspec, _loss_t, device="cpu").schedule is None
        return
    with pytest.raises(ValueError) as want:
        japi.build(jspec, _loss_j)
    with pytest.raises(ValueError) as got:
        tapi.build(tspec, _loss_t, device="cpu")
    assert str(got.value) == str(want.value)
    assert "dp-csgp" in str(got.value)


@pytest.mark.parametrize("text", ["static", "rotate:ring+complete",
                                  "erdos_renyi:period=4,p=0.7",
                                  "dropout:rate=0.2,period=6",
                                  "directed:digraph,p=0.6,period=4",
                                  "directed:ring_skips,skip=2"])
@pytest.mark.parametrize("algo", ["porter-gc", "dp-csgp", "dsgd"])
def test_build_threads_the_schedule_and_gamma_as_the_reference(text, algo):
    directed = text.startswith("directed")
    if directed and algo != "dp-csgp":
        return
    tspec, jspec = _specs(text, algo=algo, compressor="top_k", frac=0.25,
                          sigma_p=0.01)
    got = tapi.build(tspec, _loss_t, device="cpu")
    want = japi.build(jspec, _loss_j)
    assert got.gamma == want.gamma
    _assert_same_schedule(got.schedule, want.schedule)
    assert got.mixer.schedule is got.schedule and got.mixer.time_varying
    if got.engine is not None:
        assert got.engine.mixer is got.mixer


def test_zero_derived_gamma_is_refused_on_a_schedule_as_the_reference():
    for comp in ("low_rank", "sign"):
        tspec, jspec = _specs("erdos_renyi:period=4", algo="subgrad-comp",
                              compressor=comp)
        with pytest.raises(ValueError) as want:
            japi.build(jspec, _loss_j)
        with pytest.raises(ValueError) as got:
            tapi.build(tspec, _loss_t, device="cpu")
        assert str(got.value) == str(want.value)
        assert "explicit gamma" in str(got.value)
        algo = tapi.build(tspec.replace(gamma=0.3), _loss_t, device="cpu")
        assert algo.gamma == 0.3


# ---------------------------------------------------------------------------
# the executors index the table by the round
# ---------------------------------------------------------------------------

def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((n,)).astype(np.float32)}


def test_dense_mixer_indexes_the_table_by_round():
    sched = GEN_CASES["dropout"](TM)
    jmix = JG.make_dense_mixer(sched.ws)
    mix = TG.make_dense_mixer(sched.ws)
    assert mix.time_varying and jmix.time_varying
    tree = _tree(0)
    wvec = np.random.default_rng(1).uniform(0.5, 1.5, N).astype(np.float32)
    for t in range(2 * sched.period + 1):
        got = TG.apply_mixer(mix, convert.to_torch(tree, "cpu"), t)
        want = JG.apply_mixer(jmix, jax.tree_util.tree_map(jnp.asarray, tree),
                              jnp.asarray(t, jnp.int32))
        w_t = sched.at(t).astype(np.float32)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(
                got[k].numpy(), np.tensordot(w_t, tree[k], axes=1), rtol=0,
                atol=1e-6)
        pushed, w_out = mix.push(convert.to_torch(tree, "cpu"),
                                 torch.from_numpy(wvec), t)
        jpushed, jw = jmix.push(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(wvec), jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(w_out.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)
        assert w_out.dtype == torch.float32
        for k in tree:
            # the params of a push are bitwise the plain mix
            assert torch.equal(pushed[k], got[k])
            np.testing.assert_allclose(pushed[k].numpy(),
                                       np.asarray(jpushed[k]), rtol=0,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="round index"):
        TG.apply_mixer(mix, convert.to_torch(tree, "cpu"))


def test_static_dense_mixer_ignores_the_round():
    top = TM.make_topology("erdos_renyi", N, p=0.8, seed=1)
    mix = TG.make_mixer(top)
    assert not mix.time_varying and mix.schedule is None
    tree = convert.to_torch(_tree(2), "cpu")
    for k, v in mix(tree, 5).items():
        assert torch.equal(v, mix(tree)[k])


# ---------------------------------------------------------------------------
# PORTER-GC on an erdos_renyi schedule against the reference
# ---------------------------------------------------------------------------

ROUNDS = 20
ER_SCHEDULE = "erdos_renyi:period=8,p=0.8"


def _porter_kw(**over):
    return dict(dict(n_agents=10, topology="erdos_renyi",
                     topology_weights="metropolis", topology_p=0.8,
                     topology_seed=1, compressor="top_k", frac=0.05,
                     algo="porter-gc", eta=0.05, tau=1.0,
                     topology_schedule=ER_SCHEDULE), **over)


@functools.lru_cache(maxsize=None)
def reference_schedule_trajectory(model):
    (loss_j, _), params, data = PROBLEMS[model]()
    ralgo = japi.build(japi.ExperimentSpec(**_porter_kw()), loss_j)
    step = jax.jit(ralgo.step)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params))
    batches = _batches(data, ROUNDS)
    states = [state]
    for t, batch in enumerate(batches):
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                        _round_key(t))
        states.append(state)
    return states, batches, ralgo.gamma


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_porter_gc_on_an_erdos_renyi_schedule_equals_reference(model):
    states, batches, gamma = reference_schedule_trajectory(model)
    (_, loss_t), _, _ = PROBLEMS[model]()
    talgo = tapi.build(tapi.ExperimentSpec(**_porter_kw()), loss_t,
                       device="cpu")
    assert talgo.gamma == gamma and talgo.schedule.period == 8
    free = convert.state_to_torch(states[0], "cpu")
    for t in range(ROUNDS):
        batch = convert.to_torch(batches[t], "cpu")
        forced, _ = talgo.step(convert.state_to_torch(states[t], "cpu"),
                               batch, None)
        _assert_state(forced, states[t + 1], atol=1e-5)
        free, _ = talgo.step(free, batch, None)
    _assert_state(free, states[ROUNDS], atol=1e-5, fields=("x",))


# ---------------------------------------------------------------------------
# the port's own invariants (exact)
# ---------------------------------------------------------------------------

def _run(algo_name, steps, chunk, start_state=None, start=0, **over):
    kw = dict(dict(algo=algo_name, n_agents=10, topology="erdos_renyi",
                   topology_p=0.8, topology_seed=1, compressor="random_k",
                   frac=0.2, eta=0.05, tau=1.0, sigma_p=0.01), **over)
    if algo_name == "subgrad-comp":
        kw["compressor"] = "top_k"
    (_, loss_t), params, data = PROBLEMS["logreg"]()
    talgo = tapi.build(tapi.ExperimentSpec(**kw), loss_t, device="cpu")
    source = minibatch_source(*data, batch=8, device="cpu")
    state = (talgo.init(convert.to_torch(params, "cpu"))
             if start_state is None else start_state)
    state, _ = run_chunked(talgo, source, state, 5, steps, chunk=chunk,
                           start=start)
    return state


def _leaves_equal(a, b):
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


DECENTRALIZED = sorted(a for a in japi.list_algorithms()
                       if japi.algorithm_info(a).decentralized)


@pytest.mark.parametrize("algo", DECENTRALIZED)
def test_period1_static_schedule_is_the_static_topology_bitwise(algo):
    """W_0 of a static schedule is the topology's W: every round of every
    decentralized algorithm is bitwise the static one's."""
    assert _leaves_equal(_run(algo, 6, 3, topology_schedule="static"),
                         _run(algo, 6, 3))


@pytest.mark.parametrize("text", ["dropout:rate=0.3,period=3",
                                  "rotate:ring+complete+star"])
def test_schedule_follows_the_step_across_chunks_and_resume(text):
    """W_t is picked by the state's own step, so chunking and a resume in
    the middle of a period give the same trajectory, and the schedule
    does change it."""
    whole = _run("porter-dp", 7, 7, topology_schedule=text)
    assert _leaves_equal(whole, _run("porter-dp", 7, 2,
                                     topology_schedule=text))
    half = _run("porter-dp", 4, 4, topology_schedule=text)
    assert half.step == 4
    assert _leaves_equal(whole, _run("porter-dp", 7, 3, start_state=half,
                                     start=4, topology_schedule=text))
    assert not _leaves_equal(whole, _run("porter-dp", 7, 7))


def test_kernel_backend_equals_ref_backend_on_a_schedule():
    text = "straggler:rate=0.3,period=4,base=erdos_renyi"
    assert _leaves_equal(
        _run("porter-gc", 6, 3, topology_schedule=text, comm_backend="kernel"),
        _run("porter-gc", 6, 3, topology_schedule=text, comm_backend="ref"))

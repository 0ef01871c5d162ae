"""Fleet-scale agents in the port (``repro_torch.core.fleet``, the fleet
resolution of ``repro_torch.api``, ``data.dirichlet_*``) against the JAX
reference on the CPU.

Tolerances, each with its reason:

* exact: every COO triplet, dense table and spectrum of the sparse
  generators (``np.array_equal`` and float equality: the reference's numpy
  and ARPACK calls in the same order), the Dirichlet shards, the COO apply
  against the reference's scatter-add (XLA's CPU scatter adds the triplets
  one after the other in COO order; the port's slots add each row's terms
  in that order, onto +0.0, in f32), the port's fleet runs against its own
  per-device engine below the gate (the same dense mixer on the same
  table), a chunked run against the step loop, a resumed fleet run against
  the uninterrupted one, and the refusals' messages;
* atol 1e-5: one port step above the gate from each reference state
  (teacher forced): top-k sees the same inputs, the gradients are f32
  sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import fleet as JF
from repro.data import dirichlet_partition as ref_dirichlet_partition
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import fleet as TF
from repro_torch.core import FLEET_DENSE_GATE, FleetSchedule, FleetTopology
from repro_torch.core.mixing import make_topology
from repro_torch.data import (dirichlet_partition, dirichlet_source,
                              minibatch_source)
from repro_torch.launch import checkpoint as TC
from repro_torch.launch.runtime import round_generators, run_chunked
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

D, B = 24, 6
DECENTRALIZED = sorted(a for a in japi.list_algorithms()
                       if japi.algorithm_info(a).decentralized)


def _loss_t(params, batch):
    f, l = batch
    f, l = torch.atleast_2d(f), torch.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


def _loss_j(params, batch):
    f, l = batch
    f, l = jnp.atleast_2d(f), jnp.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=D)
    f = rng.normal(size=(n, B, D)).astype(np.float32)
    l = (f @ w_true > 0).astype(np.float32)
    params0 = {"w": np.zeros(D, np.float32), "b": np.float32(0.0)}
    return params0, (f, l)


def _spec_kw(name, n, *, fleet, **over):
    kw = dict(algo=name, n_agents=n, topology="ring", compressor="top_k",
              frac=0.25, eta=0.1, tau=5.0,
              sigma_p=0.01 if japi.algorithm_info(name).dp else 0.0,
              fleet=fleet)
    kw.update(over)
    return kw


def _build(name, n, *, fleet, **over):
    return tapi.build(tapi.ExperimentSpec(**_spec_kw(name, n, fleet=fleet,
                                                     **over)),
                      _loss_t, device="cpu")


def _run(algo, params0, batch, steps, seed=0):
    """``steps`` rounds on one batch, round t's generator a function of
    (seed, t): two builds see the same draws."""
    state = algo.init(convert.to_torch(params0, "cpu"))
    batch = convert.to_torch(batch, "cpu")
    losses = []
    for t in range(steps):
        _, gen = round_generators(seed, t, "cpu")
        state, m = algo.step(state, batch, gen)
        losses.append(float(m["loss"]))
    return state, np.asarray(losses)


def _tensors(state):
    return [leaf for leaf in tree_leaves(tuple(state))
            if isinstance(leaf, torch.Tensor)]


def _assert_bitwise(a, b):
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the sparse generators: the reference's tables and spectra
# ---------------------------------------------------------------------------

TOPOLOGIES = {
    "ring": lambda F: F.fleet_topology("ring", 300),
    "ring_lazy_16": lambda F: F.fleet_topology("ring", 16, weights="lazy"),
    "exponential": lambda F: F.fleet_topology("exponential", 1024),
    "exponential_lazy": lambda F: F.fleet_topology("exponential", 300,
                                                   weights="lazy"),
    "erdos_renyi": lambda F: F.fleet_topology("erdos_renyi", 600, seed=3),
    "erdos_renyi_degree": lambda F: F.fleet_topology("erdos_renyi", 300,
                                                     degree=6, seed=1),
}
SCHEDULES = {
    "er": lambda F: F.fleet_er_schedule(400, period=3, seed=2),
    "er_degree": lambda F: F.fleet_er_schedule(300, period=4, degree=6,
                                               seed=1),
    "rotate": lambda F: F.fleet_rotating_schedule(
        ["ring", "exponential/lazy"], 300),
    "rotate_three": lambda F: F.fleet_rotating_schedule(
        ["exponential", "erdos_renyi", "ring/lazy"], 260, seed=4),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_fleet_topology_equals_reference(case):
    got, want = TOPOLOGIES[case](TF), TOPOLOGIES[case](JF)
    assert (got.kind, got.n, got.nnz) == (want.kind, want.n, want.nnz)
    for name in ("rows", "cols", "vals"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.alpha == want.alpha and got.spectral_gap == want.spectral_gap
    assert np.array_equal(got.densify(), want.densify())


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_fleet_schedule_equals_reference(case):
    got, want = SCHEDULES[case](TF), SCHEDULES[case](JF)
    assert (got.kind, got.n, got.period, got.is_directed) == (
        want.kind, want.n, want.period, want.is_directed)
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    assert got.alphas == want.alphas and got.joint_alpha == want.joint_alpha
    assert got.alpha == want.alpha and got.spectral_gap == want.spectral_gap
    for t in range(got.period):
        assert np.array_equal(got.densify(t), want.densify(t))
    # the real nnz of each round: the padding triplets are the tail
    for t, live in enumerate(got.round_nnz):
        assert not np.any(got.vals[t, live:])
        assert not np.any(got.rows[t, live:]) and not np.any(
            got.cols[t, live:])
        assert got.rows[t, live - 1] == got.n - 1   # the last diagonal


def test_fleet_metropolis_matches_make_topology_and_host_helpers():
    top = TF.fleet_topology("ring", 16, weights="metropolis")
    assert np.array_equal(top.densify(), make_topology("ring", 16).w)
    x = np.random.default_rng(0).standard_normal(300)
    ring = TOPOLOGIES["ring"](TF)
    args = (300, ring.rows, ring.cols, ring.vals)
    assert np.array_equal(TF.coo_matvec(*args, x), JF.coo_matvec(*args, x))
    assert TF.coo_alpha(*args, iters=50, seed=1) == JF.coo_alpha(
        *args, iters=50, seed=1)


BAD = {
    "best_constant": lambda F: F.fleet_topology("ring", 400,
                                                weights="best_constant"),
    "unknown_kind": lambda F: F.fleet_topology("spiral", 400),
    "tiny_ring": lambda F: F.fleet_topology("ring", 2),
    "period": lambda F: F.fleet_er_schedule(300, period=0),
    "empty_rotate": lambda F: F.fleet_rotating_schedule([], 300),
    "coo_out_of_range": lambda F: F._check_coo(
        3, np.array([0, 5]), np.array([0, 1]), np.ones(2)),
    "coo_misaligned": lambda F: F._check_coo(
        3, np.array([0, 1]), np.array([0]), np.ones(2)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_generator_refusals_are_the_reference_refusals(case):
    with pytest.raises(ValueError) as want:
        BAD[case](JF)
    with pytest.raises(ValueError) as got:
        BAD[case](TF)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the COO apply against the reference's scatter-add
# ---------------------------------------------------------------------------

def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((n, 7)).astype(np.float32)}


def _apply_both(obj_j, obj_t, tree, wvec, t=None):
    jm = JF.make_fleet_mixer(obj_j, dense_gate=0)
    tm = TF.make_fleet_mixer(obj_t, dense_gate=0)
    assert jm.time_varying == tm.time_varying
    jargs = (jnp.asarray(t, jnp.int32),) if jm.time_varying else ()
    targs = (t,) if tm.time_varying else ()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jax.jit(jm)(jtree, *jargs)
    got = tm(convert.to_torch(tree, "cpu"), *targs)
    jp, jw = jm.push(jtree, jnp.asarray(wvec), *jargs)
    tp, tw = tm.push(convert.to_torch(tree, "cpu"), torch.from_numpy(wvec),
                     *targs)
    return want, got, (jp, jw), (tp, tw)


@pytest.mark.parametrize("case", ["exponential_lazy", "exponential",
                                  "erdos_renyi", "ring"])
def test_coo_apply_is_the_reference_scatter_add_bitwise(case):
    obj_j, obj_t = TOPOLOGIES[case](JF), TOPOLOGIES[case](TF)
    n = obj_t.n
    tree = _tree(n)
    wvec = np.random.default_rng(1).uniform(0.5, 1.5, n).astype(np.float32)
    want, got, (jp, jw), (tp, tw) = _apply_both(obj_j, obj_t, tree, wvec)
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        assert torch.equal(tp[k], got[k])    # push mixes the params alike
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert tw.dtype == torch.float32
    assert np.array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_coo_schedule_apply_is_the_reference_bitwise(case):
    obj_j, obj_t = SCHEDULES[case](JF), SCHEDULES[case](TF)
    n = obj_t.n
    wvec = np.random.default_rng(2).uniform(0.5, 1.5, n).astype(np.float32)
    for t in range(obj_t.period + 1):
        tree = _tree(n, seed=t)
        want, got, (jp, jw), (tp, tw) = _apply_both(obj_j, obj_t, tree,
                                                    wvec, t)
        w_t = obj_t.densify(t % obj_t.period)
        for k in tree:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))
            dense = np.tensordot(w_t, tree[k].astype(np.float64), axes=1)
            np.testing.assert_allclose(got[k].numpy(), dense, rtol=1e-5,
                                       atol=1e-5)
        assert np.array_equal(tw.numpy(), np.asarray(jw))
    mix = TF.make_fleet_mixer(obj_t, dense_gate=0)
    with pytest.raises(TypeError):
        mix(convert.to_torch(_tree(n), "cpu"))   # the round index is needed
    with pytest.raises(ValueError, match="round index"):
        mix.push(convert.to_torch(_tree(n), "cpu"), torch.ones(n))


def test_bf16_leaves_mix_in_f32_and_cast_back_as_the_reference():
    top_j, top_t = TOPOLOGIES["exponential_lazy"](JF), TOPOLOGIES[
        "exponential_lazy"](TF)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 9)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = jax.jit(JF.make_fleet_mixer(top_j, dense_gate=0))(
        {"x": jnp.asarray(x).astype(jnp.bfloat16)})["x"]
    got = TF.make_fleet_mixer(top_t, dense_gate=0)({"x": xt})["x"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(convert.to_numpy(got),
                          np.asarray(want).view(np.uint16))


def test_padding_is_dropped_from_the_layout():
    """``fleet_er_schedule`` pads every round to a common nnz with (0, 0,
    0.0) triplets on row 0; the layout keeps only the real ones."""
    sched = SCHEDULES["er"](TF)
    pads = [sched.rows.shape[1] - live for live in sched.round_nnz]
    assert max(pads) > 0
    for t, live in enumerate(sched.round_nnz):
        rank, ks, cols, vals = TF._round_layouts(sched)[t]
        assert sum(ks) == live == cols.size == vals.size
        deg = np.bincount(sched.rows[t, :live], minlength=sched.n)
        assert len(ks) == deg.max()
        row0 = sum(1 for k in ks if k > (0 if rank is None else rank[0]))
        assert row0 == deg[0]            # no padding slot on row 0
    # a FleetTopology has no padding: every triplet is a slot
    top = TOPOLOGIES["erdos_renyi"](TF)
    assert sum(TF._round_layouts(top)[0][1]) == top.nnz


def test_dropped_padding_changes_no_sign_and_only_an_inf_in_agent_0():
    """The two cases where the reference's trailing ``+ 0.0 * x[0]`` on row
    0 could matter.  A row's sum starts at +0.0 in both packages, so an
    all -0.0 input mixes to +0.0 on every row in both: no sign differs.
    An inf in agent 0's row: the reference's padding adds 0 * inf = NaN
    to row 0, the port (no padding slot) keeps the real sum."""
    obj_j, obj_t = SCHEDULES["er"](JF), SCHEDULES["er"](TF)
    n, t = obj_t.n, int(np.argmax([obj_t.rows.shape[1] - live
                                   for live in obj_t.round_nnz]))
    jm = jax.jit(JF.make_fleet_mixer(obj_j, dense_gate=0))
    tm = TF.make_fleet_mixer(obj_t, dense_gate=0)
    zeros = np.full((n, 4), -0.0, np.float32)
    want = np.asarray(jm({"x": jnp.asarray(zeros)}, jnp.asarray(t))["x"])
    got = tm({"x": torch.from_numpy(zeros)}, t)["x"].numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.signbit(got).any()
    x = np.random.default_rng(4).standard_normal((n, 4)).astype(np.float32)
    x[0, 1] = np.inf
    want = np.asarray(jm({"x": jnp.asarray(x)}, jnp.asarray(t))["x"])
    got = tm({"x": torch.from_numpy(x)}, t)["x"].numpy()
    assert np.isnan(want[0, 1]) and got[0, 1] == np.inf
    rest = np.ones_like(got, dtype=bool)
    rest[0, 1] = False
    assert np.array_equal(got[rest], want[rest], equal_nan=True)


def test_coo_apply_matches_dense_gate():
    """The COO path forced at small n against the dense path on the same
    FleetTopology (the reference's own oracle), and the mixer's surface."""
    top = TF.fleet_topology("exponential", 32, weights="lazy")
    coo = TF.make_fleet_mixer(top, dense_gate=0)
    ein = TF.make_fleet_mixer(top)
    assert coo.wire_mode == ein.wire_mode == "dense"
    assert coo.wire_frac is ein.wire_frac is None
    assert coo.budget.executor == ein.budget.executor == "fleet"
    assert coo.budget.per_leaf == {} and coo.n == ein.n == 32
    assert coo.schedule is None and not coo.time_varying
    tree = convert.to_torch(_tree(32, 3), "cpu")
    out_c, out_e = coo(tree), ein(tree)
    for k in tree:
        np.testing.assert_allclose(out_c[k].numpy(), out_e[k].numpy(),
                                   rtol=0, atol=1e-6)
    w0 = torch.ones(32)
    (tc, wc), (te, we) = coo.push(tree, w0), ein.push(tree, w0)
    np.testing.assert_allclose(wc.numpy(), we.numpy(), rtol=0, atol=1e-6)
    for k in tree:
        np.testing.assert_allclose(tc[k].numpy(), te[k].numpy(), rtol=0,
                                   atol=1e-6)
    sched = TF.fleet_er_schedule(40, period=3, degree=6, seed=1)
    mix = TF.make_fleet_mixer(sched, dense_gate=0)
    assert mix.time_varying and mix.schedule is sched
    with pytest.raises(TypeError, match="unsupported table type"):
        TF.make_fleet_mixer(np.eye(4))


# ---------------------------------------------------------------------------
# the facade: fleet=True
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DECENTRALIZED)
@pytest.mark.parametrize("n", [4, 8])
def test_fleet_matches_per_device_engine_bitwise(name, n):
    """fleet=True is bitwise the per-device engine below the gate (the same
    dense mixer on the same table)."""
    params0, batch = _problem(n)
    states, traj = [], []
    for fleet in (False, True):
        st, losses = _run(_build(name, n, fleet=fleet), params0, batch,
                          steps=10)
        states.append(st)
        traj.append(losses)
    np.testing.assert_array_equal(traj[1], traj[0])
    _assert_bitwise(states[1], states[0])
    assert np.isfinite(traj[1]).all()


def test_fleet_schedule_matches_per_device_engine_bitwise():
    n, sched = 8, "rotate:ring/metropolis+exponential/metropolis"
    params0, batch = _problem(n)
    states = [_run(_build("porter-gc", n, fleet=fleet,
                          topology_schedule=sched), params0, batch, 8)[0]
              for fleet in (False, True)]
    _assert_bitwise(states[1], states[0])


@pytest.fixture(scope="module")
def reference_fleet_512():
    """Six reference clip21 rounds at n = 512 > the gate (the COO path),
    a fresh batch each: (states, batches, gamma)."""
    n = 512
    ralgo = japi.build(japi.ExperimentSpec(**_spec_kw("clip21", n,
                                                      fleet=True)), _loss_j)
    params0, _ = _problem(4)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params0))
    step = jax.jit(ralgo.step)
    states, batches = [state], []
    for t in range(6):
        _, batch = _problem(n, seed=10 + t)
        batches.append(batch)
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                        jax.random.PRNGKey(t))
        states.append(state)
    return states, batches, ralgo.gamma


def test_fleet_above_gate_steps_as_the_reference(reference_fleet_512):
    """Above the gate: the same FleetTopology and gamma, and from every
    reference state one port step lands on the next within 1e-5."""
    states, batches, gamma = reference_fleet_512
    talgo = _build("clip21", 512, fleet=True)
    assert isinstance(talgo.topology, FleetTopology)
    assert talgo.gamma == gamma
    for t, batch in enumerate(batches):
        got, _ = talgo.step(convert.state_to_torch(states[t], "cpu"),
                            convert.to_torch(batch, "cpu"), None)
        want = convert.state_to_torch(states[t + 1], "cpu")
        assert got.base.step == want.base.step
        for a, b in zip(_tensors(got), _tensors(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("name,over", [
    ("porter-gc", dict(topology_schedule="rotate:ring+exponential")),
    ("choco", {}), ("dsgd", {})])
def test_fleet_below_gate_steps_as_the_reference_fleet(name, over):
    """Below the gate: from every reference fleet state one port fleet step
    lands on the next within 1e-5."""
    n = 8
    params0, _ = _problem(n)
    kw = _spec_kw(name, n, fleet=True, **over)
    ralgo = japi.build(japi.ExperimentSpec(**kw), _loss_j)
    step = jax.jit(ralgo.step)
    talgo = tapi.build(tapi.ExperimentSpec(**kw), _loss_t, device="cpu")
    assert talgo.gamma == ralgo.gamma and talgo.mixer.n == n
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params0))
    for t in range(5):
        _, batch = _problem(n, seed=20 + t)
        new, _ = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                      jax.random.PRNGKey(t))
        got, _ = talgo.step(convert.state_to_torch(state, "cpu"),
                            convert.to_torch(batch, "cpu"), None)
        for a, b in zip(_tensors(got),
                        _tensors(convert.state_to_torch(new, "cpu"))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)
        state = new


def test_fleet_above_gate_trains():
    n = 512
    assert n > FLEET_DENSE_GATE
    params0, _ = _problem(4)
    _, batch = _problem(n)
    algo = _build("clip21", n, fleet=True)
    assert isinstance(algo.topology, FleetTopology)
    assert algo.mixer.budget.executor == "fleet" and algo.mixer.n == n
    _, losses = _run(algo, params0, batch, steps=8)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def _refusal_pair(fn_t, fn_j):
    with pytest.raises(ValueError) as want:
        fn_j()
    with pytest.raises(ValueError) as got:
        fn_t()
    return str(got.value), str(want.value)


SPEC_REFUSALS = {
    "gossip_mode": ("porter-gc", 8, dict(gossip_mode="ring")),
    "wire": ("porter-gc", 8, dict(wire="packed_bits")),
    "push-sum": ("dp-csgp", FLEET_DENSE_GATE + 1, {}),
    "column-stochastic": ("porter-gc", 8, dict(
        topology_schedule="directed:one_way,rate=0.2,period=3")),
}


@pytest.mark.parametrize("case", sorted(SPEC_REFUSALS))
def test_fleet_spec_refusals_are_the_reference_refusals(case):
    name, n, over = SPEC_REFUSALS[case]
    kw = _spec_kw(name, n, fleet=True, **over)
    got, want = _refusal_pair(
        lambda: tapi.build(tapi.ExperimentSpec(**kw), _loss_t, device="cpu"),
        lambda: japi.build(japi.ExperimentSpec(**kw), _loss_j))
    assert got == want and case in got


@pytest.mark.parametrize("text", ["dropout:rate=0.2", "rotate:",
                                  "erdos_renyi:period=3,p=0.5",
                                  "rotate:ring,weights=best_constant"])
def test_fleet_schedule_refusals_above_the_gate(text):
    kw = _spec_kw("porter-gc", 300, fleet=True, topology_schedule=text)
    got, want = _refusal_pair(
        lambda: tapi.resolve_fleet_schedule(tapi.ExperimentSpec(**kw)),
        lambda: japi.resolve_fleet_schedule(japi.ExperimentSpec(**kw)))
    assert got == want


@pytest.mark.parametrize("text", ["rotate:ring+exponential",
                                  "rotate:kinds=ring+exponential,seed=2",
                                  "erdos_renyi:period=3,degree=6",
                                  "erdos_renyi"])
def test_fleet_schedule_resolution_above_the_gate(text):
    kw = _spec_kw("porter-gc", 300, fleet=True, topology_schedule=text)
    got = tapi.resolve_fleet_schedule(tapi.ExperimentSpec(**kw))
    want = japi.resolve_fleet_schedule(japi.ExperimentSpec(**kw))
    assert isinstance(got, FleetSchedule) and got.kind == want.kind
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    assert got.alpha == want.alpha
    algo = tapi.build(tapi.ExperimentSpec(**kw), _loss_t, device="cpu")
    assert algo.gamma == japi.build(japi.ExperimentSpec(**kw),
                                    _loss_j).gamma
    assert algo.mixer.time_varying and algo.schedule.kind == want.kind


def test_fleet_resolution_below_gate_is_dense():
    spec = tapi.ExperimentSpec(**_spec_kw("porter-gc", 8, fleet=True))
    top = tapi.resolve_fleet_topology(spec)
    assert not isinstance(top, FleetTopology)   # an ordinary Topology
    assert np.array_equal(top.w, japi.resolve_fleet_topology(
        japi.ExperimentSpec(**_spec_kw("porter-gc", 8, fleet=True))).w)
    eng = tapi.build_engine(spec)
    assert eng.mixer.budget.executor == "fleet"
    assert eng.mixer.n == 8


def test_fleet_resolution_above_gate_is_sparse():
    kw = _spec_kw("porter-gc", 512, fleet=True)
    top = tapi.resolve_fleet_topology(tapi.ExperimentSpec(**kw))
    want = japi.resolve_fleet_topology(japi.ExperimentSpec(**kw))
    assert isinstance(top, FleetTopology)
    assert top.nnz < 512 * 64 and np.array_equal(top.vals, want.vals)
    assert top.alpha == want.alpha


def test_server_algorithms_build_under_fleet_as_the_reference():
    for name in ("dp-sgd", "soteriafl"):
        algo = _build(name, 8, fleet=True)
        assert algo.topology is None and algo.mixer is None


# ---------------------------------------------------------------------------
# runtime: chunking and checkpoint resume on a fleet state
# ---------------------------------------------------------------------------

def test_fleet_chunked_runner_parity():
    """The chunked runner reproduces the per-step loop on a fleet state:
    uneven tail chunk included, bitwise."""
    n = 8
    params0, (f, l) = _problem(n)
    source = minibatch_source(f, l, 3, device="cpu")
    algo = _build("clip21", n, fleet=True)
    st_loop = algo.init(convert.to_torch(params0, "cpu"))
    for t in range(7):
        gen_b, gen_s = round_generators(0, t, "cpu")
        st_loop, _ = algo.step(st_loop, source(gen_b, t), gen_s)
    st_run, _ = run_chunked(algo, source,
                            algo.init(convert.to_torch(params0, "cpu")), 0,
                            7, chunk=3)
    _assert_bitwise(st_run, st_loop)
    assert st_run.base.step == 7


@pytest.mark.parametrize("n", [8, 300])
def test_fleet_checkpoint_resume(tmp_path, n):
    """Mid-run save -> restore -> continue is bitwise the uninterrupted run,
    below the gate and on the COO path above it."""
    params0, batch = _problem(n)
    algo = _build("clip21", n, fleet=True)
    if n > FLEET_DENSE_GATE:
        assert isinstance(algo.topology, FleetTopology)
    batch_t = convert.to_torch(batch, "cpu")

    def advance(st, t0, t1):
        for t in range(t0, t1):
            _, gen = round_generators(1, t, "cpu")
            st, _ = algo.step(st, batch_t, gen)
        return st

    st_full = advance(algo.init(convert.to_torch(params0, "cpu")), 0, 10)
    ckpt = str(tmp_path / "fleet_ckpt")
    st_half = advance(algo.init(convert.to_torch(params0, "cpu")), 0, 5)
    TC.save_state(ckpt, st_half, step=5)
    assert TC.latest_step(ckpt) == 5
    st_res = TC.restore_state(ckpt, algo.init(convert.to_torch(params0,
                                                               "cpu")))
    _assert_bitwise(st_res, st_half)
    assert st_res.base.step == 5 and type(st_res.base.step) is int
    _assert_bitwise(advance(st_res, 5, 10), st_full)


# ---------------------------------------------------------------------------
# Dirichlet shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,shard,labels", [(0.3, 0, "binary"),
                                                (0.05, 0, "binary"),
                                                (1.0, 7, "ten"),
                                                (0.3, 16, "signed")])
def test_dirichlet_partition_equals_reference(alpha, shard, labels):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(240, 10)).astype(np.float32)
    ys = {"binary": (xs[:, 0] > 0).astype(np.float32),
          "ten": rng.integers(0, 10, 240).astype(np.int32),
          "signed": np.sign(xs[:, 1]).astype(np.float32)}[labels]
    fa, la = dirichlet_partition(xs, ys, n_agents=12, alpha=alpha,
                                 shard=shard, seed=7)
    fb, lb = ref_dirichlet_partition(xs, ys, n_agents=12, alpha=alpha,
                                    shard=shard, seed=7)
    assert np.array_equal(fa, fb) and np.array_equal(la, lb)
    assert fa.shape == (12, shard or 20, 10)


def test_dirichlet_partition_refusals_and_heterogeneity():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(240, 10)).astype(np.float32)
    ys = (xs[:, 0] > 0).astype(np.float32)
    for kw in (dict(ys=ys[:10]), dict(alpha=0.0)):
        args = dict(dict(xs=xs, ys=ys, n_agents=12), **kw)
        got, want = _refusal_pair(lambda: dirichlet_partition(**args),
                                  lambda: ref_dirichlet_partition(**args))
        assert got == want
    _, la = dirichlet_partition(xs, ys, n_agents=12, alpha=0.3, seed=7)
    _, lh = dirichlet_partition(xs, ys, n_agents=12, alpha=0.05, seed=7)
    skew = np.mean(np.abs(lh.mean(axis=1) - ys.mean()))
    base = np.mean(np.abs(la.mean(axis=1) - ys.mean()))
    assert skew >= base


def test_dirichlet_source_feeds_fleet_training():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(512, D)).astype(np.float32)
    ys = (xs @ rng.normal(size=D) > 0).astype(np.float32)
    n = 8
    source = dirichlet_source(xs, ys, n_agents=n, batch=4, alpha=0.3,
                              device="cpu")
    params0, _ = _problem(n)
    algo = _build("subgrad-comp", n, fleet=True)
    state, _ = run_chunked(algo, source,
                           algo.init(convert.to_torch(params0, "cpu")), 0, 6,
                           chunk=3,
                           on_chunk=lambda t0, t1, st, m: assert_finite(m))
    assert state.step == 6
    batch = source(torch.Generator().manual_seed(0), 0)
    assert batch[0].shape == (n, 4, D) and batch[1].shape == (n, 4)


def assert_finite(metrics):
    assert torch.isfinite(metrics["loss"]).all()

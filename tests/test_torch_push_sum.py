"""DP-CSGP with push-sum in the port (``core/push_sum``, the engine's
``exchange_ps`` / ``step_ps``, the dense executor's ``push`` and the codec
executor's ``exchange_ps``) against the JAX reference on the CPU.

Both packages see the same parameters and batches (numpy), and the port is
handed the reference's N(0, 1) draws of the DP perturbation, recomputed
from its round key as ``repro.core.push_sum.dp_csgp_step`` splits it (as
``porter_step`` does).  ``top_k`` is deterministic, so no other draw
enters.

Tolerances, each with its reason:

* atol 1e-5: one step from every reference state (teacher forced) and 12
  free-running rounds on directed and doubly stochastic schedules: the
  gradients at ``z = x / xw`` and ``W_t @ c`` are f32 sums in another
  order; the reference mixes the weight as one more column of the first
  leaf's product, the port as its own (n, n) @ (n,) product;
* exact: the schedule tables, the codec's weight words (bit-cast, never
  rounded), byte counts, and the port's own laws -- dp-csgp against
  porter-dp on a doubly stochastic table (``xw`` stays exactly 1, so
  ``x / xw`` is ``x``), the kernel backend against the ref one, the
  weight planes under bf16 planes against those of the f32 run.
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
from repro.core import mixing as JM
from repro.core import push_sum as JPS
from repro.core import wire_formats as JWF
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import comm_round as TCR
from repro_torch.core import compression as TCMP
from repro_torch.core import mixing as TM
from repro_torch.core import push_sum as TPS
from repro_torch.core import wire_formats as TWF
from repro_torch.data import minibatch_source
from repro_torch.launch.runtime import run_chunked
from repro_torch.tree import tree_leaves
from test_torch_codec import oracle_c
from test_torch_porter import (FIELDS, PROBLEMS, _batches, _round_key,
                               reference_noise)

torch.set_num_threads(1)

N = 10
ROUNDS = 12
PS_FIELDS = FIELDS + ("xw", "q_w", "m_w")
GRAPH = dict(n_agents=N, topology="erdos_renyi",
             topology_weights="best_constant", topology_p=0.8,
             topology_seed=1, compressor="top_k", frac=0.05)
SCHEDULES = {
    "one_way": "directed:one_way,rate=0.3,period=4,skip=2",
    "digraph": "directed:digraph,p=0.5,period=8",
    "ring_skips": "directed:ring_skips,skip=3",
    "static": None,
    "erdos_renyi": "erdos_renyi:period=4,p=0.8",
}


def _kw(schedule, **over):
    return dict(dict(GRAPH, algo="dp-csgp", eta=0.05, tau=1.0, sigma_p=0.05,
                     topology_schedule=SCHEDULES[schedule]), **over)


def _assert_state(got, want, atol, fields=PS_FIELDS):
    for field in fields:
        g, w = getattr(got, field), getattr(want, field)
        for a, b in zip(tree_leaves(g), jax.tree_util.tree_leaves(w)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=atol, err_msg=field)


# ---------------------------------------------------------------------------
# the de-bias law
# ---------------------------------------------------------------------------

def test_debias_unit_weights_is_bit_identity():
    rng = np.random.default_rng(0)
    x = {"w": torch.from_numpy(rng.normal(size=(N, 5)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))}
    z = TPS.debias(x, torch.ones(N))
    for k in x:
        assert torch.equal(z[k], x[k])


def test_debias_equals_reference_and_floors_zero():
    rng = np.random.default_rng(1)
    x = {"w": rng.normal(size=(4, 3, 2)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
    xw = np.asarray([2.0, 0.5, 0.0, 1.7], np.float32)
    got = TPS.debias(convert.to_torch(x, "cpu"), torch.from_numpy(xw))
    want = JPS.debias(jax.tree_util.tree_map(jnp.asarray, x),
                      jnp.asarray(xw))
    for k in x:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert all(bool(torch.isfinite(v).all()) for v in got.values())


# ---------------------------------------------------------------------------
# dp-csgp against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_trajectory(model, schedule, packed=False):
    (loss_j, _), params, data = PROBLEMS[model]()
    extra = {}
    if packed:   # the codec executor's law: c = unpack(pack(delta))
        codec = JWF.make_wire_format("top_k", frac=GRAPH["frac"])
        extra = dict(compress_fn=lambda key, tree: oracle_c(codec, tree))
    ralgo = japi.build(japi.ExperimentSpec(**_kw(schedule)), loss_j,
                       **extra)
    step = jax.jit(ralgo.step)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params))
    batches = _batches(data, ROUNDS)
    states, metrics = [state], []
    for t, batch in enumerate(batches):
        state, met = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                          _round_key(t))
        states.append(state)
        metrics.append({k: float(v) for k, v in met.items()})
    noise = [reference_noise(_round_key(t), params) for t in range(ROUNDS)]
    return states, metrics, batches, noise, ralgo.gamma


def _port(model, schedule, **over):
    (_, loss_t), _, _ = PROBLEMS[model]()
    return tapi.build(tapi.ExperimentSpec(**_kw(schedule, **over)), loss_t,
                      device="cpu")


def _check_against_reference(talgo, states, metrics, batches, noise):
    free = convert.state_to_torch(states[0], "cpu")
    for t in range(ROUNDS):
        batch = convert.to_torch(batches[t], "cpu")
        z = convert.to_torch(noise[t], "cpu")
        forced, met = talgo.step(convert.state_to_torch(states[t], "cpu"),
                                 batch, None, noise=z)
        assert forced.step == t + 1
        _assert_state(forced, states[t + 1], atol=1e-5)
        assert set(met) == set(metrics[t])
        for name in met:
            np.testing.assert_allclose(float(met[name]), metrics[t][name],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        free, _ = talgo.step(free, batch, None, noise=z)
    _assert_state(free, states[ROUNDS], atol=1e-5)
    return free


@pytest.mark.parametrize("model", ["logreg", "mlp"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_dp_csgp_equals_reference(model, schedule):
    states, metrics, batches, noise, gamma = reference_trajectory(model,
                                                                  schedule)
    talgo = _port(model, schedule)
    assert talgo.gamma == gamma
    assert (talgo.schedule is None) == (SCHEDULES[schedule] is None)
    init = talgo.init(convert.to_torch(PROBLEMS[model]()[1], "cpu"))
    _assert_state(init, states[0], atol=0.0)
    free = _check_against_reference(talgo, states, metrics, batches, noise)
    xw = free.xw.double().numpy()
    np.testing.assert_allclose(xw.sum(), N, rtol=0, atol=1e-5)
    assert np.all(xw > 0)
    ws = talgo.mixer.schedule.ws if talgo.schedule else [talgo.topology.w]
    if any(not np.allclose(w.sum(1), 1.0) for w in ws):
        assert not np.allclose(xw, 1.0, atol=1e-6)   # the weights moved


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_dp_csgp_over_packed_bits_equals_the_codec_law(model):
    """The codec executor carries the weight bit-cast in its buffers: the
    same law as the reference's dense push with ``c = unpack(pack(delta))``
    (the codec's law, ``tests/test_torch_codec.py``)."""
    states, metrics, batches, noise, gamma = reference_trajectory(
        model, "one_way", packed=True)
    talgo = _port(model, "one_way", wire="packed_bits", gossip_mode="packed")
    assert talgo.gamma == gamma
    metrics = [{k: v for k, v in m.items() if k != "wire_bytes"}
               for m in metrics]
    free = convert.state_to_torch(states[0], "cpu")
    for t in range(ROUNDS):
        batch = convert.to_torch(batches[t], "cpu")
        z = convert.to_torch(noise[t], "cpu")
        forced, _ = talgo.step(convert.state_to_torch(states[t], "cpu"),
                               batch, None, noise=z)
        _assert_state(forced, states[t + 1], atol=1e-5)
        free, _ = talgo.step(free, batch, None, noise=z)
    _assert_state(free, states[ROUNDS], atol=1e-5)


# ---------------------------------------------------------------------------
# the port's own laws (exact)
# ---------------------------------------------------------------------------

def _run(algo, schedule, steps=8, w=None, **over):
    kw = _kw(schedule, **dict(dict(algo=algo, compressor="random_k",
                                   frac=0.2), **over))
    (_, loss_t), params, data = PROBLEMS["logreg"]()
    talgo = tapi.build(tapi.ExperimentSpec(**kw), loss_t, device="cpu")
    source = minibatch_source(*data, batch=8, device="cpu")
    mets = []
    state, _ = run_chunked(talgo, source,
                           talgo.init(convert.to_torch(params, "cpu"), w=w),
                           3, steps, chunk=4,
                           on_chunk=lambda t0, t1, s, m: mets.append(m))
    return talgo, state, {k: torch.cat([m[k] for m in mets])
                          for k in mets[0]}


@pytest.mark.parametrize("plane", [None, "bf16"])
@pytest.mark.parametrize("over", [dict(), dict(overlap=True),
                                  dict(comm_backend="kernel"),
                                  dict(comm_backend="ref")],
                         ids=["auto", "overlap", "kernel", "ref"])
@pytest.mark.parametrize("schedule", ["static", "erdos_renyi"])
def test_dp_csgp_is_porter_dp_bitwise_on_a_doubly_stochastic_table(
        schedule, over, plane):
    """Rows of W sum to 1: the weight increments are 0, ``xw`` stays
    exactly 1, ``z = x / 1`` is ``x``, and every draw (DP noise, SR words,
    random-k masks) comes in porter-dp's order.  porter-dp starts from the
    same mirror ``m_x = W_0 x`` (its ``init(w=W_0)``)."""
    algo, csgp, cm = _run("dp-csgp", schedule, plane_dtype=plane, **over)
    w0 = (algo.schedule.ws[0] if algo.schedule is not None
          else algo.topology.w)
    _, pdp, pm = _run("porter-dp", schedule, w=w0, plane_dtype=plane, **over)
    for field in FIELDS:
        for k, v in getattr(pdp, field).items():
            assert torch.equal(getattr(csgp, field)[k], v), (field, k)
    for field in ("xw", "q_w"):
        assert torch.equal(getattr(csgp, field), torch.ones(N))
    for name, value in pm.items():
        if name == "wire_bytes":   # + the weight's 4 bytes an agent
            assert torch.equal(cm[name] - value, torch.full_like(value, 4 * N))
        else:
            assert torch.equal(cm[name], value), name


def test_grad_override_stands_in_for_the_gradient_oracle():
    """A round handed the gradient its oracle computes (the ``g_prev`` it
    leaves) is bitwise that round, on a directed schedule whose weights
    move; a model-axis grid forces its first round so."""
    (_, loss_t), params, data = PROBLEMS["logreg"]()
    talgo = tapi.build(tapi.ExperimentSpec(**_kw("one_way")), loss_t,
                       device="cpu")
    batch = minibatch_source(*data, batch=8, device="cpu")(
        torch.Generator().manual_seed(0), 0)
    init = lambda: talgo.init(convert.to_torch(params, "cpu"))  # noqa: E731
    gen = torch.Generator().manual_seed(1)
    noise = {k: torch.randn(v.shape, generator=gen)
             for k, v in init().x.items()}
    free, met = talgo.step(init(), batch, None, noise=noise)
    forced, _ = talgo.step(init(), batch, None,
                           grad_override=(torch.zeros(N), free.g_prev))
    assert not torch.equal(free.xw, torch.ones(N))
    for field in PS_FIELDS:
        for a, b in zip(tree_leaves(getattr(forced, field)),
                        tree_leaves(getattr(free, field))):
            assert torch.equal(a, b), field


def test_weight_planes_stay_f32_under_bf16_planes():
    """The weight recursion reads no param: under bf16 planes the three
    weight planes are f32 and bitwise those of the f32 run."""
    _, f32, _ = _run("dp-csgp", "one_way", comm_backend="kernel")
    _, bf16, _ = _run("dp-csgp", "one_way", comm_backend="kernel",
                      plane_dtype="bf16")
    assert {v.dtype for v in bf16.q_x.values()} == {torch.bfloat16}
    assert {v.dtype for v in bf16.x.values()} == {torch.float32}
    for field in ("xw", "q_w", "m_w"):
        got = getattr(bf16, field)
        assert got.dtype == torch.float32 and got.shape == (N,)
        assert torch.equal(got, getattr(f32, field)), field
    assert abs(float(bf16.xw.double().sum()) - N) < 1e-5
    assert bool((bf16.xw > 0).all())
    assert not torch.equal(bf16.xw, torch.ones(N))


@pytest.mark.parametrize("wire", [dict(), dict(wire="packed_bits",
                                               gossip_mode="packed")],
                         ids=["dense", "packed_bits"])
@pytest.mark.parametrize("plane", [None, "bf16"])
def test_kernel_backend_equals_ref_backend_exactly(plane, wire):
    kw = dict(plane_dtype=plane, compressor="top_k", frac=0.05, **wire)
    _, a, ma = _run("dp-csgp", "one_way", comm_backend="kernel", **kw)
    _, b, mb = _run("dp-csgp", "one_way", comm_backend="ref", **kw)
    for field in PS_FIELDS:
        for x, y in zip(tree_leaves(getattr(a, field)),
                        tree_leaves(getattr(b, field))):
            assert x.dtype == y.dtype and torch.equal(x, y), field
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


# ---------------------------------------------------------------------------
# the engine: weight recursion, refusals, bytes
# ---------------------------------------------------------------------------

def test_step_ps_weight_recursion_matches_numpy():
    """The exact-EF weight recursion composes to
    xw' = ((1 - gamma) I + gamma W_t) xw, and keeps the total mass."""
    n = 4
    sched = TM.directed_churn_schedule(n, rate=0.3, period=4, skip=2, seed=0)
    spec = tapi.ExperimentSpec(algo="dp-csgp", n_agents=n,
                               compressor="identity",
                               topology_schedule="directed:one_way",
                               gamma=0.4, tau=1.0)
    eng = tapi.build_engine(spec, schedule=sched)
    gamma = 0.4
    rng = np.random.default_rng(3)
    x = {"w": torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32))}
    q = {"w": torch.zeros(n, 7)}
    m = {"w": torch.zeros(n, 7)}
    v = {"w": torch.zeros(n, 7)}
    xw = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    qw, mw = torch.zeros(n), torch.zeros(n)
    mass0 = float(xw.double().sum())
    nx, nq, nm = x["w"].double().numpy(), np.zeros((n, 7)), np.zeros((n, 7))
    nxw, nqw, nmw = xw.double().numpy(), np.zeros(n), np.zeros(n)
    for t in range(6):
        x, q, m, xw, qw, mw = eng.step_ps(None, x, q, m, v, xw, qw, mw,
                                          gamma, 0.0, t=t)
        w_t = sched.at(t)
        c = nx - nq
        nq, nm = nq + c, nm + w_t @ c
        nx = nx + gamma * (nm - nq)
        cw = nxw - nqw
        nqw, nmw = nqw + cw, nmw + w_t @ cw
        nxw = nxw + gamma * (nmw - nqw)
    np.testing.assert_allclose(x["w"].numpy(), nx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xw.numpy(), nxw, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(xw.double().sum()), mass0, atol=1e-4)
    assert bool((xw > 0).all())


def test_exchange_ps_refuses_a_mixer_without_weight_transport():
    class _NoPushMixer:
        time_varying = False
        wire_mode = "packed"

        def __call__(self, tree, t=None):
            return tree

    want_eng = JCR.CommRound(compressor=JCMP.make_compressor("top_k",
                                                             frac=0.25),
                             mixer=_NoPushMixer())
    eng = TCR.CommRound(compressor=TCMP.make_compressor("top_k", frac=0.25),
                        mixer=_NoPushMixer())
    with pytest.raises(ValueError) as want:
        want_eng.exchange_ps(jax.random.PRNGKey(0),
                             {"w": jnp.ones((N, 8))}, {"w": jnp.zeros((N, 8))},
                             jnp.ones((N,)), jnp.zeros((N,)))
    with pytest.raises(ValueError) as got:
        eng.exchange_ps(None, {"w": torch.ones(N, 8)},
                        {"w": torch.zeros(N, 8)}, torch.ones(N),
                        torch.zeros(N))
    assert str(got.value) == str(want.value)
    assert "weight-plane transport" in str(got.value)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((N, 7, 11)).astype(np.float32),
            "b": rng.standard_normal((N, 2100)).astype(np.float32),
            "c": rng.standard_normal((N,)).astype(np.float32)}


@pytest.mark.parametrize("comp,kw", [("top_k", dict(frac=0.05)),
                                     ("qsgd", dict(compressor_kwargs={
                                         "levels": 7}))])
@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_push_sum_wire_bytes_equal_reference(mode, comp, kw):
    spec_kw = dict(n_agents=N, compressor=comp, algo="dp-csgp", tau=1.0,
                   topology_schedule="directed:ring_skips,skip=2", **kw)
    mesh = None
    if mode == "packed":
        spec_kw.update(gossip_mode="packed", wire="packed_bits")
        mesh = jax.make_mesh((1,), ("data",))
    eng = tapi.build_engine(tapi.ExperimentSpec(**spec_kw))
    ref = japi.build_engine(japi.ExperimentSpec(**spec_kw), mesh=mesh)
    tree = _tree(2)
    t_tree = convert.to_torch(tree, "cpu")
    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    for push in (False, True):
        got = eng.wire_bytes(t_tree, push_sum=push)
        assert got == eng.wire_bytes_model(t_tree, push_sum=push)
        assert got == ref.wire_bytes(j_tree, push_sum=push)
        assert got == ref.wire_bytes_model(j_tree, push_sum=push)
        assert eng.wire_bytes(50_890, N, push_sum=push) == ref.wire_bytes(
            50_890, N, push_sum=push)
    assert (eng.wire_bytes(t_tree, push_sum=True)
            - eng.wire_bytes(t_tree)) == 4.0 * N


@pytest.mark.parametrize("name,kw", [("top_k", dict(frac=0.05)),
                                     ("block_top_k", dict(frac=0.25)),
                                     ("qsgd", dict(levels=7)),
                                     ("qsgd", dict(levels=255))])
def test_codec_weight_bytes_equal_reference(name, kw):
    got = TWF.measured_weight_nbytes(TWF.make_wire_format(name, **kw))
    want = JWF.measured_weight_nbytes(JWF.make_wire_format(name, **kw))
    assert got == want == 4


@pytest.mark.parametrize("name,kw", [("top_k", dict(frac=0.05)),
                                     ("qsgd", dict(levels=7))])
@pytest.mark.parametrize("schedule", ["static", "digraph"])
def test_codec_exchange_ps_ships_the_weight_exactly(name, kw, schedule):
    """exchange_ps is exchange plus the weight: the same (c, wc), the
    weight increment off the wire bitwise as sent, ``wcw = W_t @ dw``, and
    4 more bytes an agent in the shipped buffers."""
    spec = tapi.ExperimentSpec(**_kw(schedule, compressor=name,
                                     compressor_kwargs=(
                                         {"levels": kw["levels"]}
                                         if name == "qsgd" else {}),
                                     gossip_mode="packed",
                                     wire="packed_bits"))
    eng = tapi.build_engine(spec)
    mix = eng.mixer
    tree = convert.to_torch(_tree(3), "cpu")
    rng = np.random.default_rng(4)
    dw = torch.from_numpy(rng.uniform(-1, 1, N).astype(np.float32))
    dw[3] = -0.0
    rows = sum(-(-v[0].numel() // 2048) * N for v in tree.values())
    noise = torch.rand(rows, 2048, generator=torch.Generator().manual_seed(0))
    for t in range(3):
        c, wc = mix.exchange(None, tree, t, noise=noise)
        plain = mix.shipped_nbytes
        c2, wc2, cw, wcw = mix.exchange_ps(None, tree, dw, t, noise=noise)
        assert mix.shipped_nbytes == plain + 4 * N
        assert mix.shipped_nbytes == eng.wire_bytes(tree, push_sum=True)
        for k in tree:
            assert torch.equal(c[k], c2[k]) and torch.equal(wc[k], wc2[k])
        assert cw.dtype == torch.float32
        assert np.array_equal(cw.numpy().view(np.uint32),
                              dw.numpy().view(np.uint32))
        w_t = (mix.schedule.at(t) if mix.schedule is not None
               else tapi.resolve_topology(spec).w)
        np.testing.assert_allclose(wcw.numpy(), w_t @ dw.double().numpy(),
                                   rtol=0, atol=1e-6)


def test_init_mirrors_take_the_round0_matrix_as_the_reference():
    """m_x = W_0 x and m_w = W_0 1 (row sums), from the schedule's first
    table or the explicit ``w``; without either, the no-mix shortcut."""
    (_, loss_t), params, _ = PROBLEMS["logreg"]()
    (loss_j, _), _, _ = PROBLEMS["logreg"]()
    sched = JM.random_digraph_schedule(N, p=0.5, period=8, seed=0)
    for w in (None, sched.ws, sched.ws[3]):
        got = TPS.dp_csgp_init(convert.to_torch(params, "cpu"), N, w=w)
        want = JPS.dp_csgp_init(jax.tree_util.tree_map(jnp.asarray, params),
                                N, w=w)
        _assert_state(got, want, atol=1e-6)
        assert got.xw.dtype == got.q_w.dtype == got.m_w.dtype == torch.float32
    bf16 = TPS.dp_csgp_init(convert.to_torch(params, "cpu"), N, w=sched.ws,
                            plane_dtype=torch.bfloat16)
    assert {v.dtype for v in bf16.m_x.values()} == {torch.bfloat16}
    assert bf16.m_w.dtype == torch.float32

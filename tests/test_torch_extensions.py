"""The registry's beyond-paper algorithms in the port -- porter-adam
(``core/porter_adam``), clip21 (``core/clip21``) and subgrad-comp
(``core/subgrad``) -- and the ``sign`` / ``low_rank`` compressors, against
the JAX reference on the CPU.

Both packages see the same parameters and batches (numpy).  None of these
runs draws from the round's generator with the compressors used here
(``top_k`` and ``sign`` are deterministic); ``low_rank``'s Gaussian sketch
is the reference's, recomputed from its round key as
``repro.core.comm_round.compress_stacked`` splits it and injected through
``build(compress_fn=...)``.

Tolerances, each with its reason:

* atol 1e-5: one step from every reference state (teacher forced) and 15
  free-running rounds.  Gradients, norms and ``W @ c`` are f32 sums in
  another order; porter-adam's bias corrections are f32 powers (numpy's
  here, XLA's there, an ulp apart at most) and its square root is
  correctly rounded in both; ``low_rank``'s QR factors are LAPACK's in both
  and the projection does not depend on their signs;
* porter-adam's 15 free-running rounds: within twice the reference's own
  spread, its final x against its run from parameters one ulp away.
  Adam's ``m / sqrt(s)`` is near +-1 wherever v is small, so one ulp
  anywhere grows to ~5e-3 in 15 rounds in the reference itself
  (:func:`reference_ulp_spread`); one step from its state holds 1e-5;
* 1e-6: one compressor call on fixed rows;
* exact: clip21 at tau = inf against porter-gc with a piecewise clip at
  tau = inf, overlap against sequential, the kernel backend against the
  ref one (the port's own invariants).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import clip21 as JC21
from repro.core import compression as JCMP
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import clip21 as TC21
from repro_torch.core import compression as TCMP
from repro_torch.data import minibatch_source
from repro_torch.launch.runtime import run_chunked
from repro_torch.tree import tree_leaves
from test_torch_porter import PROBLEMS, _batches, _round_key

torch.set_num_threads(1)

ROUNDS = 15
GRAPH = dict(n_agents=10, topology="erdos_renyi",
             topology_weights="best_constant", topology_p=0.8,
             topology_seed=1, compressor="top_k", frac=0.05)

CASES = {
    "porter-adam": dict(algo="porter-adam", eta=0.01, tau=1.0),
    "clip21": dict(algo="clip21", eta=0.05, tau=0.05),
    "clip21-inf": dict(algo="clip21", eta=0.05, tau=None),
    "subgrad-top_k": dict(algo="subgrad-comp", eta=0.1, tau=1.0),
    "subgrad-sign": dict(algo="subgrad-comp", eta=0.1, tau=1.0,
                         compressor="sign", gamma=0.2),
    "subgrad-low_rank": dict(algo="subgrad-comp", eta=0.1, tau=1.0,
                             compressor="low_rank",
                             compressor_kwargs={"rank": 2}, gamma=0.2),
}




def _kw(case):
    return dict(GRAPH, **CASES[case])


def _low_rank_sketches(key, params, n, rank=2):
    """The reference's low_rank sketches for one subgrad round: the round
    key splits into (gradient, comm) keys, the comm key once per leaf and
    each leaf's key once per agent; every agent draws N(0, 1) of shape
    (ncols, r) of its leaf's near-square matrix."""
    _, k_c = jax.random.split(key)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = []
    for k_leaf, leaf in zip(jax.random.split(k_c, len(leaves)), leaves):
        d = int(np.prod(np.shape(leaf)))
        m = int(np.ceil(np.sqrt(d)))
        cols = int(np.ceil(d / m))
        r = min(rank, m, cols)
        out.append(np.stack([np.asarray(jax.random.normal(k, (cols, r)))
                             for k in jax.random.split(k_leaf, n)]))
    return treedef.unflatten(out)


@functools.lru_cache(maxsize=None)
def reference_trajectory(model, case):
    (loss_j, _), params, data = PROBLEMS[model]()
    ralgo = japi.build(japi.ExperimentSpec(**_kw(case)), loss_j)
    step = jax.jit(ralgo.step)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params))
    batches = _batches(data, ROUNDS)
    states, metrics = [state], []
    for t, batch in enumerate(batches):
        state, met = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                          _round_key(t))
        states.append(state)
        metrics.append({k: float(v) for k, v in met.items()})
    sketches = ([_low_rank_sketches(_round_key(t), params, 10)
                 for t in range(ROUNDS)] if "low_rank" in case
                else [None] * ROUNDS)
    return states, metrics, batches, sketches, ralgo.gamma


@functools.lru_cache(maxsize=None)
def reference_ulp_spread(model, case):
    """max |x - x'| after ``ROUNDS`` reference rounds, x' from parameters
    one ulp up: how far the reference's own trajectory moves under one
    rounding."""
    (loss_j, _), params, data = PROBLEMS[model]()
    nudged = {k: np.nextafter(v, np.float32(np.inf))
              for k, v in params.items()}
    ralgo = japi.build(japi.ExperimentSpec(**_kw(case)), loss_j)
    step = jax.jit(ralgo.step)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, nudged))
    for t, batch in enumerate(_batches(data, ROUNDS)):
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                        _round_key(t))
    want = reference_trajectory(model, case)[0][ROUNDS]
    return max(float(jnp.max(jnp.abs(state.base.x[k] - want.base.x[k])))
               for k in params)


def _port(model, case, sketch=None):
    (_, loss_t), _, _ = PROBLEMS[model]()
    spec = tapi.ExperimentSpec(**_kw(case))
    if sketch is None:
        return tapi.build(spec, loss_t, device="cpu")
    comp = TCMP.make_compressor("low_rank", rank=2)

    def compress_fn(gen, tree):
        return {k: comp(gen, leaf.reshape(leaf.shape[0], -1),
                        sketch=sketch[0][k]).reshape(leaf.shape)
                for k, leaf in tree.items()}

    return tapi.build(spec, loss_t, device="cpu", compress_fn=compress_fn)


def _fields(state):
    """(name, tree) of every buffer of a state, nested ones flattened."""
    out = []
    for name in state._fields:
        value = getattr(state, name)
        if name == "step":
            continue
        if hasattr(value, "_fields"):
            out += [(f"{name}.{n}", v) for n, v in _fields(value)]
        else:
            out.append((name, value))
    return out


def _assert_close(port_state, ref_state, atol):
    for (name, got), (_, want) in zip(_fields(port_state),
                                      _fields(ref_state)):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=atol, err_msg=name)


@pytest.mark.parametrize("model", ["logreg", "mlp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_equals_reference(model, case):
    states, metrics, batches, sketches, gamma = reference_trajectory(
        model, case)
    holder = [None]
    talgo = _port(model, case, sketch=holder if "low_rank" in case else None)
    assert talgo.gamma == gamma
    free = convert.state_to_torch(states[0], "cpu")
    for t in range(ROUNDS):
        batch = convert.to_torch(batches[t], "cpu")
        if sketches[t] is not None:
            holder[0] = convert.to_torch(sketches[t], "cpu")
        forced, met = talgo.step(convert.state_to_torch(states[t], "cpu"),
                                 batch, None)
        _assert_close(forced, states[t + 1], atol=1e-5)
        assert set(met) == set(metrics[t])
        for name in met:
            np.testing.assert_allclose(float(met[name]), metrics[t][name],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        free, _ = talgo.step(free, batch, None)
    if case == "porter-adam":
        spread = reference_ulp_spread(model, case)
        assert spread > 1e-4
        diff = max(float(np.max(np.abs(free.base.x[k].numpy() - np.asarray(
            states[ROUNDS].base.x[k])))) for k in free.base.x)
        assert diff <= 2 * spread, (diff, spread)
    else:
        _assert_close(free, states[ROUNDS], atol=1e-5)
    if case == "clip21":   # the residual clip was active, then let go
        assert metrics[0]["clip_residual"] > 0.0


def test_init_equals_reference():
    for case in CASES:
        states, *_ = reference_trajectory("logreg", case)
        _, params, _ = PROBLEMS["logreg"]()
        state = _port("logreg", case).init(convert.to_torch(params, "cpu"))
        assert type(state).__name__ == type(states[0]).__name__
        _assert_close(state, states[0], atol=0.0)


# ---------------------------------------------------------------------------
# clip21's estimate update and its tau = inf reduction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [0.01, 0.5, 3.0, float("inf")])
def test_clip21_update_equals_reference_and_contracts(tau):
    rng = np.random.default_rng(int(tau * 100) if np.isfinite(tau) else 7)
    est = {"a": rng.standard_normal((6, 4, 3)).astype(np.float32),
           "b": rng.standard_normal((6,)).astype(np.float32)}
    raw = {k: v + rng.standard_normal(v.shape).astype(np.float32)
           for k, v in est.items()}
    got = TC21.clip21_update(convert.to_torch(est, "cpu"),
                             convert.to_torch(raw, "cpu"), tau)
    want = jax.vmap(lambda e, r: JC21.clip21_update(e, r, tau))(
        jax.tree_util.tree_map(jnp.asarray, est),
        jax.tree_util.tree_map(jnp.asarray, raw))
    for k in est:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    # every agent's residual shrinks by tau in norm, or to 0
    r0 = np.sqrt(sum(((raw[k] - est[k]).reshape(6, -1) ** 2).sum(1)
                     for k in est))
    r1 = np.sqrt(sum(((raw[k] - got[k].numpy()).reshape(6, -1) ** 2).sum(1)
                     for k in est))
    assert np.all(r1 <= np.maximum(r0 - tau, 0.0) + 1e-5)
    if tau == float("inf"):
        for k in est:
            assert torch.equal(got[k], convert.to_torch(raw[k], "cpu"))


def _run(algo, steps=8, **over):
    kw = dict(GRAPH, algo=algo, eta=0.05, compressor="random_k", frac=0.2,
              **over)
    (_, loss_t), params, data = PROBLEMS["logreg"]()
    talgo = tapi.build(tapi.ExperimentSpec(**kw), loss_t, device="cpu")
    source = minibatch_source(*data, batch=8, device="cpu")
    state, _ = run_chunked(talgo, source,
                           talgo.init(convert.to_torch(params, "cpu")), 3,
                           steps, chunk=4)
    return state


def _equal(a, b):
    la = [v for _, t in _fields(a) for v in tree_leaves(t)]
    lb = [v for _, t in _fields(b) for v in tree_leaves(t)]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_clip21_at_tau_inf_is_porter_gc_piecewise_bitwise(backend):
    clip21 = _run("clip21", tau=None, comm_backend=backend)
    porter = _run("porter-gc", tau=float("inf"), clip_mode="piecewise",
                  comm_backend=backend)
    assert _equal(clip21.base, porter)
    # the estimate is the last raw gradient, porter-gc's unclipped g_prev
    for k, v in clip21.g_est.items():
        assert torch.equal(v, porter.g_prev[k])


# ---------------------------------------------------------------------------
# the port's own invariants (exact)
# ---------------------------------------------------------------------------

ALGOS = {"porter-adam": dict(tau=1.0), "clip21": dict(tau=0.05),
         "subgrad-comp": dict(tau=1.0)}


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_kernel_backend_equals_ref_backend_exactly(algo):
    for plane in (None, "bf16"):
        kw = dict(ALGOS[algo], plane_dtype=plane)
        assert _equal(_run(algo, comm_backend="kernel", **kw),
                      _run(algo, comm_backend="ref", **kw)), plane


@pytest.mark.parametrize("algo", ["porter-adam", "clip21"])
def test_overlap_equals_sequential_exactly(algo):
    assert _equal(_run(algo, overlap=True, **ALGOS[algo]),
                  _run(algo, overlap=False, **ALGOS[algo]))


def test_porter_adam_moments_stay_f32_under_bf16_planes():
    state = _run("porter-adam", plane_dtype="bf16", tau=1.0)
    assert {v.dtype for v in state.base.q_x.values()} == {torch.bfloat16}
    assert {v.dtype for v in state.base.x.values()} == {torch.float32}
    for tree in (state.m, state.s):
        assert {v.dtype for v in tree.values()} == {torch.float32}
    assert all(bool(torch.isfinite(v).all()) for v in state.base.x.values())


def test_porter_adam_bias_corrections_and_root_are_the_reference_f32():
    """``1 - b ** (t + 1)`` in f32 as the jitted reference forms it
    (bitwise over 2,000 rounds), and the root of ``s / bc2`` correctly
    rounded on the CPU, where ``torch.sqrt(267.0)`` can be an ulp low."""
    from repro_torch.core.porter_adam import _bias_correction, _sqrt
    want = jax.jit(lambda s: (1.0 - 0.9 ** (s + 1).astype(jnp.float32),
                              1.0 - 0.999 ** (s + 1).astype(jnp.float32)))
    for t in range(0, 2000, 7):
        w1, w2 = want(jnp.int32(t))
        assert float(_bias_correction(0.9, t, "cpu")) == float(w1), t
        assert float(_bias_correction(0.999, t, "cpu")) == float(w2), t
    s = torch.tensor([267.0, 2.0, 1e-8, 12345.678], dtype=torch.float32)
    np.testing.assert_array_equal(_sqrt(s).numpy(),
                                  np.sqrt(s.numpy()))
    np.testing.assert_array_equal(_sqrt(s).numpy(),
                                  np.asarray(jnp.sqrt(jnp.asarray(s.numpy()))))


def test_subgrad_stepsize_is_the_reference_f32_schedule():
    from repro_torch.core.subgrad import _stepsize
    for t in (0, 1, 2, 3, 7, 99, 12345):
        want = np.float32(0.1) * jax.lax.rsqrt(jnp.float32(t) + 1.0)
        np.testing.assert_allclose(_stepsize(0.1, t), float(want), rtol=2e-7)
        assert float(np.float32(_stepsize(0.1, t))) == _stepsize(0.1, t)


# ---------------------------------------------------------------------------
# the sign and low_rank compressors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4, 7, 123, 1000])
def test_sign_and_low_rank_equal_reference(d):
    rows = np.random.default_rng(d).standard_normal((5, d)).astype(np.float32)
    rows[0, : d // 2] = 0.0
    sign_ref = np.stack([np.asarray(JCMP.sign()(None, jnp.asarray(r)))
                         for r in rows])
    got = TCMP.sign()(None, torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), sign_ref, rtol=0, atol=1e-6)
    for rank, iters in ((1, 1), (2, 1), (4, 2)):
        keys = jax.random.split(jax.random.PRNGKey(d), 5)
        comp = JCMP.low_rank(rank, iters)
        want = np.stack([np.asarray(comp(k, jnp.asarray(r)))
                         for k, r in zip(keys, rows)])
        m = int(np.ceil(np.sqrt(d)))
        cols = int(np.ceil(d / m))
        r = min(rank, m, cols)
        sketch = np.stack([np.asarray(jax.random.normal(k, (cols, r)))
                           for k in keys])
        got = TCMP.low_rank(rank, iters)(None, torch.from_numpy(rows),
                                         sketch=torch.from_numpy(sketch))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_low_rank_draws_its_sketch_from_the_generator():
    rows = torch.randn(3, 500, generator=torch.Generator().manual_seed(0))
    comp = TCMP.low_rank(2)
    a = comp(torch.Generator().manual_seed(1), rows)
    b = comp(torch.Generator().manual_seed(1), rows)
    c = comp(torch.Generator().manual_seed(2), rows)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _expected_rho(name, d):
    """The tightest rho each scheme provably satisfies (the reference's
    ``tests/test_compression.py``): sign ||x||_1^2 / (d ||x||_2^2) >= 1 / d;
    low_rank only its projection bound (rho 0, per draw)."""
    return 1.0 / d if name == "sign" else 0.0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("d", [4, 37, 500, 2999])
@pytest.mark.parametrize("name", ["sign", "low_rank"])
def test_definition3_contract_every_compressor(name, d, seed):
    """E||C(x) - x||^2 <= (1 - rho) ||x||^2 (paper Definition 3), with the
    reference's contract cases: sign is deterministic; low_rank projects,
    so it contracts on every one of 128 sketches."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(d)
                         .astype(np.float32))
    nrm = float(torch.sum(x ** 2))
    comp = TCMP.make_compressor(name, **({"rank": 2, "power_iters": 1}
                                         if name == "low_rank" else {}))
    if comp.deterministic:
        err = float(torch.sum((comp(None, x[None])[0] - x) ** 2))
        assert err <= (1.0 - _expected_rho(name, d)) * nrm + 1e-5 * nrm
        n1 = float(torch.sum(torch.abs(x)))
        np.testing.assert_allclose(err, (1 - n1 ** 2 / (d * nrm)) * nrm,
                                   rtol=1e-4)
        return
    errs = torch.sum((comp(torch.Generator().manual_seed(seed),
                           x.expand(128, d)) - x) ** 2, dim=1)
    assert float(errs.max()) <= nrm * (1.0 + 1e-5)

"""The port's core modules against the JAX reference on the same inputs.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances, each with its reason:

* exact: compression (a selection and a copy), topologies, mixing matrices
  and privacy accounting (the same numpy code), wire-byte models (integer
  arithmetic), and port ``ref`` backend vs port ``kernel`` backend (the same
  f32 operations, leafwise or over the flat planes);
* atol 1e-6: clipping and the dense mixer (f32 reductions and products
  whose summation order differs between XLA and PyTorch);
* atol 1e-5: a whole comm round against the reference (an f32 matrix
  product feeds the fused update), as the reference's own engine parity
  tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as JC
from repro.core import comm_round as JCR
from repro.core import compression as JCMP
from repro.core import gossip as JG
from repro.core import mixing as JM
from repro.core import privacy as JP
from repro_torch import convert
from repro_torch.core import clipping as TC
from repro_torch.core import comm_round as TCR
from repro_torch.core import compression as TCMP
from repro_torch.core import gossip as TG
from repro_torch.core import mixing as TM
from repro_torch.core import privacy as TP

torch.set_num_threads(1)

N = 5
# scalar leaf, non-multiple-of-8 vector, 3-D leaf, a leaf crossing a tile
ODD_SHAPES = {"b": (), "w": (123,), "k": (7, 11, 3), "big": (9000,)}


def _stacked(seed, shapes=ODD_SHAPES, n=N, ints=False):
    rng = np.random.default_rng(seed)
    if ints:  # many exact ties in magnitude
        return {k: rng.integers(-3, 4, (n,) + s).astype(np.float32)
                for k, s in shapes.items()}
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in shapes.items()}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return convert.to_torch(tree, "cpu")


def _assert_tree(port, ref, atol=0.0):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert sorted(port) == sorted(ref)
    for k in ref:
        got = port[k].detach().numpy()
        assert got.shape == ref[k].shape and got.dtype == ref[k].dtype, k
        if atol == 0.0:
            np.testing.assert_array_equal(got, ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(got, ref[k], rtol=0, atol=atol,
                                       err_msg=k)


def _top(n=10):
    return (JM.make_topology("erdos_renyi", n, "best_constant", p=0.8,
                             seed=1),
            TM.make_topology("erdos_renyi", n, "best_constant", p=0.8,
                             seed=1))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.05, 0.3])
@pytest.mark.parametrize("ints", [False, True], ids=["tie_free", "ties"])
def test_top_k_equals_reference(frac, ints):
    """Per agent row of every leaf; the 10-element and scalar leaves keep
    k = 1.  With integer inputs the k-th magnitude is tied, and the lowest
    index wins on both sides."""
    tree = _stacked(3, dict(ODD_SHAPES, c2=(10,)), ints=ints)
    ref = JCR.compress_stacked(JCMP.top_k(frac), jax.random.PRNGKey(0),
                               _j(tree))
    got = TCR.compress_stacked(TCMP.top_k(frac), None, _t(tree))
    _assert_tree(got, ref)
    kept = int((got["c2"] != 0).sum(-1).max())
    assert kept == max(int(round(frac * 10)), 1)


def test_random_k_with_injected_mask_equals_reference():
    frac, d = 0.25, 777
    rows = np.random.default_rng(4).standard_normal((N, d)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    comp = JCMP.random_k(frac)
    ref = np.stack([np.asarray(comp(k, jnp.asarray(r)))
                    for k, r in zip(keys, rows)])
    mask = np.stack([np.asarray(jax.random.bernoulli(k, frac, (d,)))
                     for k in keys])
    got = TCMP.random_k(frac)(None, torch.from_numpy(rows),
                              mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_random_k_draws_from_the_generator():
    frac = 0.25
    rows = torch.randn(N, 4000, generator=torch.Generator().manual_seed(0))
    comp = TCMP.random_k(frac)
    a = comp(torch.Generator().manual_seed(7), rows)
    b = comp(torch.Generator().manual_seed(7), rows)
    c = comp(torch.Generator().manual_seed(8), rows)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = float((a != 0).float().mean())
    assert abs(kept - frac) < 0.02  # 20,000 Bernoulli(0.25) draws: sd 0.003
    assert torch.equal(a[a != 0], rows[a != 0])


@pytest.mark.parametrize("name,kw", [("identity", {}),
                                     ("top_k", {"frac": 0.05}),
                                     ("random_k", {"frac": 0.1}),
                                     ("block_top_k", {"frac": 0.05}),
                                     ("qsgd", {}),
                                     ("qsgd", {"levels": 7})])
def test_compressor_contract_and_wire_bits_equal_reference(name, kw):
    ref, got = JCMP.make_compressor(name, **kw), TCMP.make_compressor(name,
                                                                      **kw)
    assert (got.rho, got.deterministic, got.bits_per_element) == (
        ref.rho, ref.deterministic, ref.bits_per_element)
    for d in (1, 10, 124, 50890):
        assert got.wire_bits(d) == ref.wire_bits(d)


@pytest.mark.parametrize("name", ["low_rank", "sign"])
def test_compressors_of_later_slices_raise(name):
    """``low_rank`` and ``sign`` are ported now: they report the
    reference's rho (0), flags and wire bits, and a derived gamma with
    them is refused as the reference refuses it."""
    ref, got = JCMP.make_compressor(name), TCMP.make_compressor(name)
    assert (got.name, got.rho, got.deterministic, got.bits_per_element) == (
        ref.name, ref.rho, ref.deterministic, ref.bits_per_element)
    for d in (1, 10, 124, 50890):
        assert got.wire_bits(d) == ref.wire_bits(d)
    from repro_torch import api as tapi
    import repro.api as japi
    kw = dict(algo="subgrad-comp", n_agents=N, compressor=name)
    with pytest.raises(ValueError) as want:
        japi.build(japi.ExperimentSpec(**kw), lambda p, b: 0.0)
    with pytest.raises(ValueError) as port:
        tapi.build(tapi.ExperimentSpec(**kw), lambda p, b: 0.0,
                   device="cpu")
    assert str(port.value) == str(want.value)


@pytest.mark.parametrize("frac", [0.05, 0.3])
@pytest.mark.parametrize("ints", [False, True], ids=["tie_free", "ties"])
def test_block_top_k_equals_reference(frac, ints):
    """Exactly k per 2048-block (the row padded to whole blocks), ties to
    the lowest index as jax.lax.top_k."""
    tree = _stacked(14, ints=ints)
    got = TCR.compress_stacked(TCMP.block_top_k(frac), None, _t(tree))
    want = JCMP.compress_tree(JCMP.block_top_k(frac), jax.random.PRNGKey(0),
                              _j(tree))
    _assert_tree(got, want)


@pytest.mark.parametrize("levels", [7, 16])
def test_qsgd_with_injected_noise_equals_reference(levels):
    """The dense-wire qsgd on the reference's uniforms.  atol 1e-6: the
    row norm is an f32 reduction in another order, so a value may move by
    an ulp; a rounding code moves only if a uniform falls in that sliver."""
    rows = np.random.default_rng(15).standard_normal((N, 3001)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(16), N)
    comp = JCMP.qsgd(levels)
    want = np.stack([np.asarray(comp(k, jnp.asarray(r)))
                     for k, r in zip(keys, rows)])
    noise = np.stack([np.asarray(jax.random.uniform(k, (3001,)))
                      for k in keys])
    got = TCMP.qsgd(levels)(None, torch.from_numpy(rows),
                            noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    drawn = TCMP.qsgd(levels)(torch.Generator().manual_seed(0),
                              torch.from_numpy(rows))
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


def test_compress_stacked_per_agent_rows():
    """Each agent's row of a leaf is compressed on its own: row i of the
    stacked result equals compressing agent i alone."""
    tree = _t(_stacked(6))
    comp = TCMP.top_k(0.1)
    out = TCR.compress_stacked(comp, None, tree)
    for k, leaf in tree.items():
        for i in range(N):
            alone = comp(None, leaf[i].reshape(1, -1)).reshape(leaf.shape[1:])
            assert torch.equal(out[k][i], alone)


# ---------------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------------

def _logreg_loss_j(params, batch):
    f, l = batch
    f, l = jnp.atleast_2d(f), jnp.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    nll = jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))
    return nll + 0.2 * jnp.sum(params["w"] ** 2 / (1 + params["w"] ** 2))


def _logreg_loss_t(params, batch):
    f, l = batch
    f, l = torch.atleast_2d(f), torch.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    nll = torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))
    return nll + 0.2 * torch.sum(params["w"] ** 2 / (1 + params["w"] ** 2))


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_operators_equal_reference(scale):
    rng = np.random.default_rng(8)
    x = (scale * rng.standard_normal((7, 11))).astype(np.float32)
    tau = 1.0
    np.testing.assert_allclose(
        TC.smooth_clip(torch.from_numpy(x), tau).numpy(),
        np.asarray(JC.smooth_clip(jnp.asarray(x), tau)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        TC.piecewise_clip(torch.from_numpy(x), tau).numpy(),
        np.asarray(JC.piecewise_clip(jnp.asarray(x), tau)), rtol=0,
        atol=1e-6)
    tree = {k: (scale * v[0]) for k, v in _stacked(9).items()}
    np.testing.assert_allclose(
        float(TC.tree_global_norm(_t(tree))),
        float(JC.tree_global_norm(_j(tree))), rtol=1e-6)
    for mode in ("smooth", "piecewise", "none"):
        _assert_tree(TC.tree_clip(_t(tree), tau, mode),
                     JC.tree_clip(_j(tree), tau, mode), atol=1e-6)


@pytest.mark.parametrize("mode", ["smooth", "piecewise"])
def test_clipped_grad_accumulate_equals_reference(mode):
    """PORTER-DP line 6: per-sample gradients (vmap here, a scan in the
    reference), each clipped, then averaged."""
    rng = np.random.default_rng(10)
    params = {"w": rng.standard_normal(123).astype(np.float32),
              "b": np.float32(0.3)}
    batch = ((rng.random((6, 123)) < 0.11).astype(np.float32),
             (rng.random(6) < 0.5).astype(np.float32))
    g_j, loss_j = JC.clipped_grad_accumulate(_logreg_loss_j, _j(params),
                                             _j(batch), 0.5, mode)
    g_t, loss_t = TC.clipped_grad_accumulate(_logreg_loss_t, _t(params),
                                             _t(batch), 0.5, mode)
    _assert_tree(g_t, g_j, atol=1e-6)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# topologies, privacy
# ---------------------------------------------------------------------------

def test_paper_topology_equals_reference_exactly():
    ref, got = _top()
    np.testing.assert_array_equal(got.adjacency, ref.adjacency)
    np.testing.assert_array_equal(got.w, ref.w)
    assert got.alpha == ref.alpha and got.spectral_gap == ref.spectral_gap


@pytest.mark.parametrize("kind,n", [("ring", 7), ("torus", 12),
                                    ("complete", 5), ("star", 6),
                                    ("exponential", 9), ("hypercube", 8),
                                    ("erdos_renyi", 9)])
@pytest.mark.parametrize("weights", ["metropolis", "best_constant", "lazy"])
def test_topologies_equal_reference_exactly(kind, n, weights):
    ref = JM.make_topology(kind, n, weights, p=0.5, seed=3)
    got = TM.make_topology(kind, n, weights, p=0.5, seed=3)
    np.testing.assert_array_equal(got.w, ref.w)
    assert got.alpha == ref.alpha
    assert TM.spectral_gap(got.w) == JM.spectral_gap(ref.w)


def test_privacy_accounting_equals_reference():
    assert TP.phi_m(124, 2000, 0.1, 1e-3) == JP.phi_m(124, 2000, 0.1, 1e-3)
    sigma = TP.calibrate_sigma(1.0, 400, 2000, 0.1, 1e-3)
    assert sigma == JP.calibrate_sigma(1.0, 400, 2000, 0.1, 1e-3)
    for T in (1, 400, 10_000):
        assert TP.ldp_epsilon(1.0, sigma, T, 2000, 1e-3) == JP.ldp_epsilon(
            1.0, sigma, T, 2000, 1e-3)
    a, b = TP.MomentsAccountant(0.01, 2.0), JP.MomentsAccountant(0.01, 2.0)
    a.step(300)
    b.step(300)
    assert a.epsilon(1e-5) == b.epsilon(1e-5)
    assert a.delta(1.0) == b.delta(1.0)


# ---------------------------------------------------------------------------
# gossip and wire accounting
# ---------------------------------------------------------------------------

def test_dense_mixer_equals_reference():
    ref_top, top = _top()
    tree = _stacked(11, n=10)
    _assert_tree(TG.make_dense_mixer(top.w)(_t(tree)),
                 JG.make_dense_mixer(ref_top.w)(_j(tree)), atol=1e-6)
    # a (period, n, n) table mixes with W_{t mod period}
    table = np.stack([top.w, np.eye(10)])
    mix = TG.make_dense_mixer(table)
    assert mix.time_varying
    for t in range(3):
        _assert_tree(mix(_t(tree), t),
                     JG.make_dense_mixer(table)(_j(tree), t), atol=1e-6)
    # the ring executor takes a ring band only, as the reference's
    with pytest.raises(ValueError, match="not a circulant ring band"):
        TG.make_mixer(top, "ring")


@pytest.mark.parametrize("mode", ["dense", "ring", "packed"])
@pytest.mark.parametrize("n,d", [(2, 124), (10, 50890), (10, 1)])
def test_gossip_wire_bytes_equal_reference(mode, n, d):
    assert TG.gossip_wire_bytes(mode, n, d, frac=0.05) == \
        JG.gossip_wire_bytes(mode, n, d, frac=0.05)


@pytest.mark.parametrize("comp", ["identity", "top_k", "random_k"])
def test_engine_wire_bytes_equal_reference(comp):
    ref_top, top = _top()
    kw = {} if comp == "identity" else {"frac": 0.05}
    ref = JCR.CommRound(JCMP.make_compressor(comp, **kw),
                        JG.make_mixer(ref_top, "dense"))
    got = TCR.CommRound(TCMP.make_compressor(comp, **kw),
                        TG.make_mixer(top, "dense"))
    tree = _stacked(12, n=10)
    assert got.wire_bytes(_t(tree)) == ref.wire_bytes(_j(tree))
    assert got.wire_bytes(50890, n_agents=10) == ref.wire_bytes(
        50890, n_agents=10)


# ---------------------------------------------------------------------------
# the comm-round engine
# ---------------------------------------------------------------------------

def test_resolve_backend_and_slice_limits():
    assert TCR.resolve_backend("auto", "cpu") == "ref"
    assert TCR.resolve_backend("auto", torch.device("cuda", 0)) == "kernel"
    assert TCR.resolve_backend("kernel", "cpu") == "kernel"
    with pytest.raises(ValueError):
        TCR.resolve_backend("pallas", "cpu")
    comp = TCMP.top_k(0.1)
    with pytest.raises(ValueError):
        TCR.CommRound(comp, None, backend="cuda")
    with pytest.raises(ValueError, match="bf16"):
        TCR.CommRound(comp, None, plane_dtype=torch.float16)
    TCR.CommRound(comp, None, plane_dtype=torch.bfloat16)
    eng = TCR.CommRound(comp, None)
    assert TCR.resolve_engine(eng) is eng
    with pytest.raises(ValueError, match="conflicting"):
        TCR.resolve_engine(eng, compressor=TCMP.top_k(0.1))


def _engines(frac=0.1):
    ref_top, top = _top(N)
    ref = JCR.CommRound(JCMP.top_k(frac), JG.make_mixer(ref_top, "dense"),
                        backend="ref")
    mixer = TG.make_mixer(top, "dense")
    ports = {b: TCR.CommRound(TCMP.top_k(frac), mixer, backend=b)
             for b in ("ref", "kernel")}
    return ref, ports


def test_comm_round_track_equals_reference():
    """Port ref == port kernel (plane path, plain kernels) exactly; both ==
    the JAX ref backend at atol 1e-5."""
    ref, ports = _engines()
    bufs = [_stacked(20 + i) for i in range(5)]  # v, q, m, g, g_prev
    v, q, m, g, gp = bufs[:5]
    gamma = 0.0371
    want = ref.track(jax.random.PRNGKey(0), *map(_j, (v, q, m, g, gp)),
                     gamma)
    outs = {b: e.track(None, *map(_t, (v, q, m, g, gp)), gamma)
            for b, e in ports.items()}
    for got_r, got_k, w in zip(outs["ref"], outs["kernel"], want):
        _assert_tree(got_k, {k: t.numpy() for k, t in got_r.items()})
        _assert_tree(got_r, w, atol=1e-5)


def test_comm_round_step_equals_reference():
    ref, ports = _engines()
    x, q, m, v = [_stacked(30 + i) for i in range(4)]
    gamma, eta = 0.0371, 0.05
    want = ref.step(jax.random.PRNGKey(0), *map(_j, (x, q, m, v)), gamma,
                    eta)
    outs = {b: e.step(None, *map(_t, (x, q, m, v)), gamma, eta)
            for b, e in ports.items()}
    for got_r, got_k, w in zip(outs["ref"], outs["kernel"], want):
        _assert_tree(got_k, {k: t.numpy() for k, t in got_r.items()})
        _assert_tree(got_r, w, atol=1e-5)


def test_exchange_keeps_the_mirror_identity():
    """m == W q after rounds of exchange + update (the wire identity)."""
    _, ports = _engines(0.2)
    eng = ports["kernel"]
    _, top = _top(N)
    w = torch.as_tensor(top.w, dtype=torch.float32)
    x = _t(_stacked(40))
    q = {k: torch.zeros_like(t) for k, t in x.items()}
    m = {k: torch.zeros_like(t) for k, t in x.items()}
    v = _t(_stacked(41))
    for _ in range(4):
        x, q, m = eng.step(None, x, q, m, v, 0.05, 0.01)
    for k in x:
        want = (w @ q[k].reshape(N, -1)).reshape(q[k].shape)
        np.testing.assert_allclose(m[k].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)

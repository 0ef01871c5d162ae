"""The port's facade, registry, data, model and weight bridge against the
JAX reference.  Exact unless stated: specs, registrations, stepsizes and
the synthetic data come from the same numpy code; the MLP's loss and
gradient are f32 reductions, held at atol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import paper_logreg as jlogreg
from repro.configs import paper_mnist as jmnist
from repro.data import synthetic as jsyn
from repro.models import paper as jpaper
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.configs import paper_logreg as tlogreg
from repro_torch.configs import paper_mnist as tmnist
from repro_torch.core import PorterState
from repro_torch.data import minibatch_source
from repro_torch.data import synthetic as tsyn
from repro_torch.models import paper as tpaper

torch.set_num_threads(1)

SLICE = ("beer", "choco", "clip21", "dp-csgp", "dp-sgd", "dsgd",
         "porter-adam", "porter-dp", "porter-gc", "soteriafl",
         "subgrad-comp")


def _loss(params, batch):
    return torch.sum(params["w"]) * 0.0


def test_spec_fields_and_defaults_follow_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(japi.ExperimentSpec)}
    for f in dataclasses.fields(tapi.ExperimentSpec):
        assert f.name in ref, f.name
        if f.name not in ("buffer_dtype", "compressor_kwargs"):
            assert f.default == ref[f.name], f.name


def test_registry_holds_the_slice():
    """All eleven of the reference's algorithms, with its capabilities."""
    assert tapi.list_algorithms() == SLICE == tuple(
        sorted(japi.list_algorithms()))
    for name in SLICE:
        got, want = tapi.algorithm_info(name), japi.algorithm_info(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="unknown algorithm"):
        tapi.algorithm_info("no-such-algo")


@pytest.mark.parametrize("over", [dict(gossip_mode="packed",
                                       topology="complete"),
                                  dict(topology_schedule="static",
                                       gossip_mode="ring"),
                                  dict(gossip_mode="ring", plane_dtype="bf16"),
                                  dict(gossip_mode="ring"),
                                  dict(gossip_mode="packed"),
                                  dict(gossip_mode="ring",
                                       wire="packed_bits")])
def test_options_of_later_slices_raise(over):
    """These options raised before the ring and plain packed executors
    were ported; each now builds and runs, and its exchange equals the
    dense executor's ``W @ c`` on the same increment within 1e-6 in f32
    (the packed executor's on a per-window k-sparse one, which it ships
    whole; the bf16 ring's within one bf16 unit of the dense product's
    terms: a static ring's bands multiply bf16 leaves in bf16)."""
    from repro_torch.core.compression import block_top_k
    from repro_torch.core.gossip import apply_mixer, make_dense_mixer
    from repro_torch.tree import tree_leaves, tree_map

    def loss(p, batch):
        return 0.5 * torch.sum((p["w"] - batch["y"]) ** 2)

    spec = tapi.ExperimentSpec(**over)
    algo = tapi.build(spec, loss, device="cpu")
    g = torch.Generator().manual_seed(0)
    n = spec.n_agents
    state = algo.init({"w": torch.randn(300, 7, generator=g)})
    for t in range(3):
        state, met = algo.step(state, {"y": torch.randn(n, 300, 7,
                                                        generator=g)},
                               torch.Generator().manual_seed(t))
        assert torch.isfinite(met["loss"])
    y = tree_map(lambda v: v.to(torch.float32), state.v)
    if spec.wire == "packed_bits":
        c, wc = algo.engine.exchange(None, y, tree_map(torch.zeros_like, y),
                                     state.step)
    else:
        c = (tree_map(lambda v: block_top_k(spec.frac)(None, v.reshape(
            n, -1)).reshape(v.shape), y) if spec.gossip_mode == "packed"
             else algo.engine.compress(None, state.v))
        wc = apply_mixer(algo.mixer, c, state.step)
    schedule = algo.mixer.schedule
    dense = make_dense_mixer(algo.topology.w if schedule is None
                             else schedule.ws)
    want = apply_mixer(dense, tree_map(lambda v: v.to(torch.float32), c),
                       state.step)
    for got, w in zip(tree_leaves(wc), tree_leaves(want)):
        err = float((got.to(torch.float32) - w).abs().max())
        if got.dtype == torch.bfloat16:
            assert err <= 2.0 ** -7 * float(w.abs().max())
        else:
            assert err <= 1e-6


def test_packed_bits_errors_are_the_reference_errors():
    """Dense gossip has no codec form, and a compress_fn beside a codec
    would be ignored: both raise the reference's own messages."""
    bad = (dict(wire="packed_bits"), dict(wire="bits"))
    for over in bad:
        with pytest.raises(ValueError) as want:
            japi.build(japi.ExperimentSpec(**over), lambda p, b: 0.0)
        with pytest.raises(ValueError) as got:
            tapi.build(tapi.ExperimentSpec(**over), _loss, device="cpu")
        assert str(got.value) == str(want.value)
    spec = tapi.ExperimentSpec(wire="packed_bits", gossip_mode="packed")
    with pytest.raises(ValueError, match="compress_fn override would be "
                       "silently ignored"):
        tapi.build(spec, _loss, device="cpu",
                   compress_fn=lambda gen, tree: tree)
    # on the dense wire the override is the compression
    halve = tapi.build(tapi.ExperimentSpec(), _loss, device="cpu",
                       compress_fn=lambda gen, tree: {
                           k: v / 2 for k, v in tree.items()})
    y, q = {"w": torch.ones(10, 3)}, {"w": torch.zeros(10, 3)}
    c, _ = halve.engine.exchange(None, y, q)
    assert torch.equal(c["w"], torch.full((10, 3), 0.5))
    for comp in ("top_k", "block_top_k", "qsgd"):
        algo = tapi.build(spec.replace(compressor=comp), _loss, device="cpu")
        assert algo.mixer.wire_codec.name == (
            "qsgd_bits" if comp == "qsgd" else "topk_bits")
        assert algo.engine.mixer is algo.mixer


@pytest.mark.parametrize("over", [dict(), dict(topology="ring"),
                                  dict(compressor="random_k", frac=0.2),
                                  dict(compressor="identity"),
                                  dict(compressor="qsgd"),
                                  dict(compressor="qsgd",
                                       compressor_kwargs={"levels": 7}),
                                  dict(compressor="block_top_k",
                                       wire="packed_bits",
                                       gossip_mode="packed"),
                                  dict(gamma=0.3), dict(gamma_scale=0.25)])
def test_gamma_and_topology_resolve_as_the_reference(over):
    kw = dict(dict(n_agents=10, topology="erdos_renyi",
                   topology_weights="best_constant", topology_seed=1), **over)
    got = tapi.build(tapi.ExperimentSpec(**kw), _loss, device="cpu")
    mesh = (jax.make_mesh((1,), ("data",))
            if kw.get("gossip_mode") == "packed" else None)
    want = japi.build(japi.ExperimentSpec(**kw), lambda p, b: 0.0, mesh=mesh)
    assert got.gamma == want.gamma
    np.testing.assert_array_equal(got.topology.w, want.topology.w)
    assert got.compressor.rho == want.compressor.rho


def test_porter_dp_rejects_unclipped_and_porter_gc_without_tau_is_beer():
    with pytest.raises(ValueError, match="tau"):
        tapi.build(tapi.ExperimentSpec(algo="porter-dp", tau=None), _loss,
                   device="cpu")
    algo = tapi.build(tapi.ExperimentSpec(tau=None), _loss, device="cpu")
    assert algo.config.variant == "beer"


def test_protocol_constants_equal_reference():
    for name in ("N_AGENTS", "GRAPH", "DIM", "LAMBDA", "RHO", "TAU", "BATCH",
                 "PRIVACY_LEVELS"):
        assert getattr(tlogreg, name) == getattr(jlogreg, name), name
    for name in ("INPUT_DIM", "HIDDEN", "CLASSES"):
        assert getattr(tmnist, name) == getattr(jmnist, name), name


def test_synthetic_data_is_bit_identical():
    for fn, kw in ((tsyn.a9a_like, dict(num=3001, dim=123, seed=4)),
                   (tsyn.mnist_like, dict(num=2001, seed=5))):
        got = fn(**kw)
        want = getattr(jsyn, fn.__name__)(**kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        xs, ys = tsyn.shard_to_agents(*got, 10, seed=6)
        jxs, jys = jsyn.shard_to_agents(*want, 10, seed=6)
        np.testing.assert_array_equal(xs, jxs)
        np.testing.assert_array_equal(ys, jys)


def test_minibatch_source_draws_per_agent_rows_from_the_generator():
    xs = np.arange(10 * 50 * 3, dtype=np.float32).reshape(10, 50, 3)
    ys = np.arange(10 * 50, dtype=np.float32).reshape(10, 50)
    source = minibatch_source(xs, ys, batch=8, device="cpu")
    f, l = source(torch.Generator().manual_seed(0), 0)
    assert f.shape == (10, 8, 3) and l.shape == (10, 8)
    # every agent draws only from its own shard, and rows stay paired
    assert torch.all((l // 50) == torch.arange(10)[:, None])
    assert torch.equal(f[..., 0], 3 * l)
    again, _ = source(torch.Generator().manual_seed(0), 1)
    other, _ = source(torch.Generator().manual_seed(1), 0)
    assert torch.equal(f, again) and not torch.equal(f, other)


def test_mlp_loss_and_gradient_equal_reference():
    params = jax.tree_util.tree_map(np.asarray,
                                    jpaper.mlp_init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(7)
    batch = (rng.random((16, 784)).astype(np.float32),
             rng.integers(0, 10, 16).astype(np.int32))
    want_loss, want_g = jax.value_and_grad(jpaper.mlp_loss())(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, batch))
    tp = {k: v.requires_grad_(True)
          for k, v in convert.to_torch(params, "cpu").items()}
    loss = tpaper.mlp_loss()(tp, convert.to_torch(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(tp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=0,
                               atol=1e-6)
    for k, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_mlp_init_shapes_follow_the_reference():
    got = tpaper.mlp_init(seed=0, device="cpu")
    want = jpaper.mlp_init()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert float(got["c1"].abs().max()) == 0.0


def test_convert_round_trips_state_exactly():
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((10, 123)).astype(np.float32),
            "b": rng.standard_normal(10).astype(np.float32)}
    ref_state = PorterState(*(dict(tree) for _ in range(7)),
                            step=np.int32(17))
    state = convert.state_to_torch(ref_state, "cpu")
    assert isinstance(state, PorterState) and state.step == 17
    back = convert.state_to_numpy(state)
    for field in PorterState._fields[:-1]:
        for k in tree:
            np.testing.assert_array_equal(getattr(back, field)[k], tree[k])
    assert back.step == np.int32(17)


# ---------------------------------------------------------------------------
# every registered algorithm trains (tests/test_api_registry.py's contract)
# ---------------------------------------------------------------------------

def _registry_loss_j(params, batch):
    f, l = batch
    f, l = jnp.atleast_2d(f), jnp.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))


def _registry_loss_t(params, batch):
    f, l = batch
    f, l = torch.atleast_2d(f), torch.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


def _registry_problem():
    """The reference registry test's problem: 4 agents, d = 24, 6 samples
    each."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=24)
    f = rng.normal(size=(4, 6, 24)).astype(np.float32)
    return f, (f @ w_true > 0).astype(np.float32)


@pytest.mark.parametrize("name", sorted(japi.list_algorithms()))
def test_registered_algorithm_trains(name):
    """build -> init -> 120 steps: the reference's metric keys, positive
    wire bytes, a loss that falls."""
    kw = dict(algo=name, n_agents=4, topology="ring", compressor="top_k",
              frac=0.25, eta=0.1, tau=5.0, sigma_p=0.0)
    f, l = _registry_problem()
    ralgo = japi.build(japi.ExperimentSpec(**kw), _registry_loss_j)
    _, want = ralgo.step(ralgo.init({"w": jnp.zeros(24), "b": jnp.zeros(())}),
                         (jnp.asarray(f), jnp.asarray(l)),
                         jax.random.PRNGKey(0))
    algo = tapi.build(tapi.ExperimentSpec(**kw), _registry_loss_t,
                      device="cpu")
    assert algo.name == name and algo.info == tapi.algorithm_info(name)
    state = algo.init({"w": torch.zeros(24), "b": torch.zeros(())})
    assert isinstance(state, algo.state_cls)
    assert type(state).__name__ == type(ralgo.init(
        {"w": jnp.zeros(24), "b": jnp.zeros(())})).__name__
    batch = (torch.from_numpy(f), torch.from_numpy(l))
    gen = torch.Generator().manual_seed(0)
    first = None
    for _ in range(120):
        state, m = algo.step(state, batch, gen)
        first = float(m["loss"]) if first is None else first
    assert set(m) == set(want)
    assert float(m["wire_bytes"]) > 0
    assert float(m["wire_bytes"]) == float(want["wire_bytes"])
    last = float(m["loss"])
    assert np.isfinite(last) and last < first

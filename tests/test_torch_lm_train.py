"""LM training in the port: the agent-vmapped gradient of every family's
loss, the token batches (``repro_torch.data.batch_source`` /
``token_batch``), one PORTER-GC step of ``launch.steps.build_train_step``
from the reference's state, ``remat_policy`` and the entry point
``launch.train.main``, against the JAX package where it has the same
function.

Gates: the vmapped gradient of two agents within 1e-6 normwise of each
agent's own (the batched products may sum in another order); one PORTER-GC
step (``comm_backend="ref"``, ``frac=1.0``, so that no tie at the k-th
magnitude can pick other entries) from the reference's state with the
reference's token batch injected through numpy: every leaf of ``x`` within
1e-5; remat bitwise the gradient without it; ``main``'s ``[model]`` line
the reference's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from lm_parity import DECODERS, ENCDEC, cfgs, jparams, params
from repro import api as japi
from repro.data.synthetic import token_batch as jtoken_batch
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core.remat import DOTS_REPLAYS, apply_remat
from repro_torch.data import batch_source, token_batch
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

N = 2
ARCHS = DECODERS + [ENCDEC, "rwkv6-7b", "zamba2-7b"]
SEQ = {"rwkv6-7b": 32, "zamba2-7b": 64}   # each takes its chunked scan


def _stacked(tree, n=N):
    return tree_map(lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape))
                    .clone(), tree)


def _agent_batch(cfg, seq, seed=11):
    source = batch_source(cfg, N, 2, seq, device="cpu")
    return source(torch.Generator().manual_seed(seed), 0)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "minicpm3-4b",
                                  "grok-1-314b", "arctic-480b",
                                  "paligemma-3b", "seamless-m4t-medium",
                                  "rwkv6-7b", "zamba2-7b"])
def test_vmapped_gradient_is_each_agents_own(arch):
    _, tcfg = cfgs(arch, "f32")
    _, p = params(arch)
    # distinct agents: the second one's parameters moved a little
    x = _stacked(p)
    for leaf in tree_leaves(x):
        leaf[1].mul_(1.01)
    seq = {"rwkv6-7b": 32, "zamba2-7b": 64}.get(arch, 24)
    batch = _agent_batch(tcfg, seq)
    loss = build_model(tcfg, device="cpu").loss
    g, losses = vmap(grad_and_value(loss))(x, batch)
    for i in range(N):
        gi, li = grad_and_value(loss)(
            tree_map(lambda t: t[i], x), {k: v[i] for k, v in batch.items()})
        assert abs(float(losses[i]) - float(li)) <= 1e-6 * abs(float(li))
        for a, b in zip(tree_leaves(g), tree_leaves(gi)):
            err = float(torch.linalg.vector_norm(a[i] - b))
            assert err <= 1e-6 * max(float(torch.linalg.vector_norm(b)),
                                     1e-30)


@pytest.mark.parametrize("arch,keys", [
    ("tinyllama-1.1b", {"tokens"}),
    ("rwkv6-7b", {"tokens"}),
    ("paligemma-3b", {"tokens", "patches"}),
    ("seamless-m4t-medium", {"frames", "tokens"}),
])
def test_batch_source_families(arch, keys):
    """The reference's ``test_batch_source_families`` layout, with the
    dtypes: int32 tokens, f32 patches and frames."""
    cfg = get_smoke(arch)
    out = batch_source(cfg, n_agents=2, batch=3, seq=32, device="cpu")(
        torch.Generator().manual_seed(0), 0)
    assert set(out) == keys
    for k, t in out.items():
        assert tuple(t.shape[:2]) == (2, 3), (k, t.shape)
        assert t.dtype == (torch.int32 if k == "tokens" else torch.float32)
    if "patches" in out:
        assert out["tokens"].shape[2] == 32 - cfg.n_prefix
        assert tuple(out["patches"].shape[2:]) == (cfg.n_prefix,
                                                   cfg.frontend_dim)
    if "frames" in out:
        assert tuple(out["frames"].shape[2:]) == (32, cfg.frontend_dim)
    assert int(out["tokens"].min()) >= 0
    assert int(out["tokens"].max()) < cfg.vocab


def test_token_batch_range_and_stream():
    draw = token_batch(torch.Generator().manual_seed(4), 3, 5, 64, 7)
    assert draw.dtype == torch.int32 and tuple(draw.shape) == (3, 5, 64)
    assert int(draw.min()) == 0 and int(draw.max()) == 6
    again = token_batch(torch.Generator().manual_seed(4), 3, 5, 64, 7)
    assert torch.equal(draw, again)
    other = token_batch(torch.Generator().manual_seed(5), 3, 5, 64, 7)
    assert not torch.equal(draw, other)
    # the reference draws the same layout
    want = jtoken_batch(jax.random.PRNGKey(0), 3, 5, 64, 7)
    assert want.dtype == jnp.int32 and want.shape == tuple(draw.shape)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-7b"])
def test_porter_gc_step_from_the_reference_state(arch):
    jcfg, tcfg = cfgs(arch, "f32")
    np_params, _ = params(arch)
    seq = 32
    knobs = dict(compressor="top_k", frac=1.0, comm_backend="ref",
                 eta=3e-2, tau=1.0, topology_weights="metropolis")
    jalgo = japi.build(japi.ExperimentSpec(algo="porter-gc", n_agents=N,
                                           **knobs), jbuild_model(jcfg).loss)
    jstep = jax.jit(jalgo.step)
    tokens = jtoken_batch(jax.random.PRNGKey(3), N, 2, seq, jcfg.vocab)
    jstate = jalgo.init(jparams(np_params))
    # one warm step so that every buffer (v, q_v, g_prev) is live
    jstate, _ = jstep(jstate, {"tokens": tokens}, jax.random.PRNGKey(1))
    tokens2 = jtoken_batch(jax.random.PRNGKey(4), N, 2, seq, jcfg.vocab)
    jnext, jmet = jstep(jstate, {"tokens": tokens2}, jax.random.PRNGKey(2))

    setup = steps.build_train_step(
        tcfg, N, compressor_name="top_k", frac=1.0, comm_backend="ref",
        eta=3e-2, tau=1.0, device="cpu")
    assert setup.algorithm.gamma == jalgo.gamma
    state = convert.state_to_torch(jax.device_get(jstate), "cpu")
    batch = {"tokens": torch.from_numpy(np.array(tokens2))}
    new, met = setup.step(state, batch, None)
    got, want = _flat(convert.to_numpy(new.x)), _flat(jax.device_get(jnext.x))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_train_setup_defaults_are_the_reference():
    _, tcfg = cfgs("tinyllama-1.1b", "f32")
    setup = steps.build_train_step(tcfg, 4, device="cpu")
    spec = setup.algorithm.spec
    assert spec.algo == "porter-gc" and spec.compressor == "block_top_k"
    assert (spec.frac, spec.topology, spec.tau, spec.eta) == (0.05, "ring",
                                                              1.0, 1e-3)
    assert spec.topology_weights == "metropolis"
    assert setup.porter_cfg.eta == 1e-3
    state = setup.init_state(torch.Generator().manual_seed(0))
    assert tree_leaves(state.x)[0].shape[0] == 4


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradient_is_bitwise_the_plain_one(arch, policy):
    _, tcfg = cfgs(arch, "f32")
    _, p = params(arch)
    x = _stacked(p)
    batch = _agent_batch(tcfg, SEQ.get(arch, 32))
    loss = build_model(tcfg, device="cpu").loss
    g0, l0 = vmap(grad_and_value(loss))(x, batch)
    DOTS_REPLAYS.clear()
    g1, l1 = vmap(grad_and_value(apply_remat(loss, policy)))(x, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
    if policy == "dots":   # the recompute took the forward's products
        assert DOTS_REPLAYS["replayed"] > 0
        assert DOTS_REPLAYS["computed"] == 0


def _two_products(calls, mutation):
    """A loss of two products whose recompute (its second call) takes
    ``mutation``: drops the second product, swaps the two, or adds a third
    of a recorded key."""
    def loss(p, b):
        calls.append(1)
        again = len(calls) > 1
        h, y = b["x"] @ p["a"], None
        if again and mutation == "swap":
            y = b["x"] @ p["b"]
            h = b["x"] @ p["a"]
        elif not (again and mutation == "drop"):
            y = h @ p["b"]
        if again and mutation == "extra":
            y = y + h @ p["b"]
        return (h.sum() if y is None else y.sum())
    return loss


@pytest.mark.parametrize("mutation", ["drop", "swap", "extra"])
def test_remat_dots_refuses_records_that_do_not_line_up(mutation):
    """A recompute whose products are not the forward's, key for key and
    in order, raises instead of handing a product another one's output."""
    g = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(4, 4, generator=g),
         "b": torch.randn(4, 4, generator=g)}
    b = {"x": torch.randn(3, 4, generator=g)}
    calls = []
    fn = apply_remat(_two_products(calls, mutation), "dots")
    with pytest.raises(RuntimeError, match="remat 'dots'"):
        grad_and_value(fn)(p, b)
    calls.clear()
    grad_and_value(apply_remat(_two_products(calls, None), "dots"))(p, b)
    assert len(calls) == 2


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_step_and_per_sample_gradients(policy):
    """Through ``build`` (every algorithm gets the wrapped loss): a
    PORTER-GC step and a PORTER-DP step (per-sample gradients, two vmaps)
    bitwise the steps without remat."""
    _, tcfg = cfgs("tinyllama-1.1b", "f32")
    _, p = params("tinyllama-1.1b")
    batch = _agent_batch(tcfg, 16)
    for algo in ("porter-gc", "porter-dp"):
        runs = []
        for pol in (None, policy):
            setup = steps.build_train_step(
                tcfg, N, variant=algo, compressor_name="top_k",
                comm_backend="ref", remat_policy=pol, sigma_p=0.1,
                device="cpu")
            state = setup.algorithm.init(p)
            noise = tree_map(torch.ones_like, state.x)
            kw = {"noise": noise} if algo == "porter-dp" else {}
            runs.append(setup.step(state, batch,
                                   torch.Generator().manual_seed(0), **kw))
        (a, ma), (b, mb) = runs
        assert torch.equal(ma["loss"], mb["loss"])
        for u, v in zip(tree_leaves(a.x), tree_leaves(b.x)):
            assert torch.equal(u, v)


def test_unknown_remat_policy_raises_the_reference_error():
    with pytest.raises(ValueError) as want:
        japi.build(japi.ExperimentSpec(remat_policy="all"),
                   lambda p, b: 0.0)
    with pytest.raises(ValueError) as got:
        tapi.build(tapi.ExperimentSpec(remat_policy="all"),
                   lambda p, b: 0.0, device="cpu")
    assert str(got.value) == str(want.value)


def _model_line(out):
    return re.search(r"^\[model\] .*$", out, re.M).group(0)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "grok-1-314b",
                                  "rwkv6-7b"])
def test_main_trains_on_cpu(arch, capsys):
    ops.reset_launches()
    assert train.main(["--arch", arch, "--smoke", "--steps", "3",
                       "--device", "cpu", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert len(re.findall(r"^  step +\d+  loss \d", out, re.M)) == 3
    assert "[done] loss" in out
    assert set(ops.LAUNCHES.values()) == {0}   # the CPU launches nothing
    if arch == "tinyllama-1.1b":
        args = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "16"]
        assert jtrain.main(args) == 0
        want = _model_line(capsys.readouterr().out)
        assert train.main(args + ["--device", "cpu"]) == 0
        assert _model_line(capsys.readouterr().out) == want


def test_main_dp_prints_the_privacy_lines(capsys):
    assert train.main(["--smoke", "--algo", "porter-dp", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^\[privacy\] sigma_p=", out, re.M)
    assert "[privacy] executed 2 rounds this run" in out


def test_scan_guard_sees_operands_under_torch_func():
    """The scan wrappers' guard on the card: an operand that needs grad or
    is wrapped by ``grad`` / ``vmap`` counts, a plain one does not (under
    ``vmap`` a tensor's ``requires_grad`` says nothing)."""
    seen = []

    def probe(t):
        seen.append(ops._needs_grad((t,)))
        return t * 2

    t = torch.ones(3, 4)
    probe(t)
    vmap(probe)(t)
    torch.func.grad(lambda u: probe(u).sum())(t)
    probe(t.clone().requires_grad_(True))
    assert seen == [False, True, True, True]


def test_donated_run_is_the_plain_run_and_frees_each_old_state():
    """``run_chunked(donate=True)`` gives the same rounds bit for bit and
    releases the storage of every state it has moved past, the one it was
    given included (the reference's donation)."""
    from repro_torch.launch.runtime import run_chunked

    _, tcfg = cfgs("tinyllama-1.1b", "f32")
    _, p = params("tinyllama-1.1b")
    setup = steps.build_train_step(tcfg, N, compressor_name="top_k",
                                   device="cpu")
    source = batch_source(tcfg, N, 2, 16, device="cpu")
    runs, given = [], []
    for donate in (False, True):
        state = setup.algorithm.init(p)
        given.append(state)
        seen = []
        final, _ = run_chunked(setup.algorithm, source, state, 3, 5,
                               chunk=2, donate=donate,
                               on_chunk=lambda t0, t1, st, m: seen.append(
                                   [t.clone() for t in tree_leaves(st.x)]))
        runs.append((final, seen))
    (a, seen_a), (b, seen_b) = runs
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v)
    for xa, xb in zip(seen_a, seen_b):   # each chunk's state, at its end
        assert all(torch.equal(u, v) for u, v in zip(xa, xb))
    assert all(t.untyped_storage().nbytes() > 0
               for t in tree_leaves(given[0].x))
    assert all(t.untyped_storage().nbytes() == 0
               for t in tree_leaves(given[1].x))
    assert all(t.untyped_storage().nbytes() > 0 for t in tree_leaves(b.x))


@pytest.mark.parametrize("algo,fleet",
                         [(a, False) for a in tapi.list_algorithms()]
                         + [("porter-gc", True)])
def test_donated_run_of_every_algorithm_is_the_plain_run(algo, fleet):
    """``main`` donates each round's old state for every algorithm: the
    donated run's chunks, metrics and final state are bit for bit the
    run without donation, and the state it was given is released."""
    from repro_torch.launch.runtime import run_chunked

    _, tcfg = cfgs("tinyllama-1.1b", "f32")
    _, p = params("tinyllama-1.1b")
    dp = tapi.algorithm_info(algo).dp
    setup = steps.build_train_step(tcfg, 3, variant=algo,
                                   compressor_name="top_k",
                                   sigma_p=0.1 if dp else 0.0, fleet=fleet,
                                   device="cpu")
    source = batch_source(tcfg, 3, 2, 16, device="cpu")
    runs, given = [], []
    for donate in (False, True):
        state = setup.algorithm.init(p)
        given.append(state)
        seen = []
        final, _ = run_chunked(
            setup.algorithm, source, state, 3, 4, chunk=2, donate=donate,
            on_chunk=lambda t0, t1, st, m: seen.append(
                [t.clone() for t in tree_leaves(st)
                 if isinstance(t, torch.Tensor)]
                + [m[k].clone() for k in sorted(m)]))
        runs.append((final, seen))
    (a, seen_a), (b, seen_b) = runs
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v)
    assert len(seen_a) == len(seen_b) == 2
    for xa, xb in zip(seen_a, seen_b):
        assert len(xa) == len(xb)
        assert all(torch.equal(u, v) for u, v in zip(xa, xb))
    kept = {t.untyped_storage().data_ptr() for t in tree_leaves(b)
            if isinstance(t, torch.Tensor)}
    old = [t.untyped_storage() for t in tree_leaves(given[1])
           if isinstance(t, torch.Tensor)]
    assert all(st.nbytes() == 0 or st.data_ptr() in kept for st in old)
    assert any(st.nbytes() == 0 for st in old)


@pytest.mark.parametrize("algo", tapi.list_algorithms())
def test_main_runs_every_algorithm(algo, capsys):
    assert train.main(["--smoke", "--algo", algo, "--steps", "2",
                       "--batch", "2", "--seq", "16", "--agents", "3",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"algo={algo} " in out and "[done] loss" in out

"""The bit-packed wire path (``wire="packed_bits"``, ``gossip_mode="packed"``)
through the port's packed codec executor, against the JAX reference.

The reference runs its codec executor as a ``shard_map`` program with one
agent per device; the port holds all agents on one card, where the
all-gather is the identity.  Each agent computes the same thing in both:
``c_i = unpack(pack(delta_i))`` and ``wc_i = sum_j w_ij unpack(bufs_j)``.
That law is what the reference holds its own executors to
(``tests/test_wire_pack.py``: the per-agent round trip, then the dense
mixer), and what these tests hold the port to.

Tolerances, each with its reason:

* exact: ``c`` of the top-k codec (the same selection and bf16 cast per
  window); the port's ``kernel`` backend against its ``ref`` backend and
  chunk 1 against chunk 4 (the same plain codecs and the same draws); byte
  counts (integer arithmetic);
* atol 1e-5: ``wc`` (an f32 product summed in another order) and the
  reference's real 4-device executor (its qsgd scale sums the squares in
  XLA's order, a few ulps from the port's); one PORTER-GC step from every
  reference state (teacher-forced), as the reference's engine parity tests
  use;
* atol 1e-4 on x: 30 free-running PORTER-GC rounds, where the f32
  rounding of gradients and of ``W @ c`` compounds.
"""

import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import gossip as JG
from repro.core import mixing as JM
from repro.core import wire_formats as JWF
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import gossip as TG
from repro_torch.core import mixing as TM
from repro_torch.core import wire_formats as TWF
from repro_torch.data import minibatch_source
from repro_torch.launch.runtime import run_chunked
from test_torch_porter import (FIELDS, PAPER_GRAPH, PROBLEMS, _assert_state,
                               _batches, _round_key)

torch.set_num_threads(1)

N = 5
# leaves that pad separately: 77 -> 1 window, 2100 -> 2, a scalar -> 1
SHAPES = {"a": (7, 11), "b": (2100,), "c": ()}
ROUNDS = 30
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _f32(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def oracle_c(codec, tree):
    """The reference codec's law for one agent-stacked tree: every agent's
    leaf is windowed, packed, unpacked and cut back, in the leaf's dtype
    (``tests/test_wire_pack.py``'s ``oracle_c``, single process)."""
    def leaf(x):
        flat = x.reshape(x.shape[0], -1).astype(jnp.float32)

        def one(v):
            rows = JWF.to_windows(v)
            return JWF.from_windows(codec.unpack(*codec.pack(None, rows)),
                                    v.shape[0])
        return jax.vmap(one)(flat).reshape(x.shape).astype(x.dtype)
    return jax.tree_util.tree_map(leaf, tree)


def _paper_w(n):
    kw = dict(weights="best_constant", p=0.8, seed=1)
    jw = JM.make_topology("erdos_renyi", n, **kw).w
    tw = TM.make_topology("erdos_renyi", n, **kw).w
    np.testing.assert_array_equal(tw, jw)
    return tw


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("frac", [0.25, 0.05])
@pytest.mark.parametrize("comp", ["block_top_k", "top_k"])
def test_exchange_law_equals_the_reference_codec(comp, frac, dtype):
    w = _paper_w(N)
    tree = _tree(1)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    if dtype == "bf16":
        jtree = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                       jtree)
    codec = JWF.make_wire_format(comp, frac=frac)
    want_c = jax.jit(lambda t: oracle_c(codec, t))(jtree)
    want_wc = JG.make_dense_mixer(w)(want_c)
    mix = TG.make_mixer(TM.make_topology("erdos_renyi", N,
                                         weights="best_constant", p=0.8,
                                         seed=1), "packed", frac=frac,
                        codec=TWF.make_wire_format(comp, frac=frac))
    c, wc = mix.exchange(None, convert.to_torch(
        jax.tree_util.tree_map(np.asarray, jtree), "cpu"))
    for k in SHAPES:
        assert c[k].dtype == wc[k].dtype == convert.to_torch(
            np.asarray(jtree[k]), "cpu").dtype
        np.testing.assert_array_equal(_bits(convert.to_numpy(c[k])),
                                      _bits(want_c[k]))
        np.testing.assert_allclose(_f32(convert.to_numpy(wc[k])),
                                   _f32(want_wc[k]), rtol=0, atol=1e-5)
    windows = 4 * N
    assert mix.shipped_nbytes == windows * 4 * TWF.topk_keep(frac)


def test_codec_mixer_refuses_a_plain_mix_and_dense_gossip():
    top = TM.make_topology("ring", N)
    codec = TWF.make_wire_format("top_k", frac=0.25)
    mix = TG.make_mixer(top, "packed", codec=codec)
    assert (mix.wire_mode, mix.wire_codec) == ("packed", codec)
    with pytest.raises(ValueError, match="mix.exchange"):
        mix(convert.to_torch(_tree(2), "cpu"))
    with pytest.raises(ValueError, match="dense gossip ships the dense"):
        TG.make_mixer(top, "dense", codec=codec)
    # the ring and plain packed executors build on one card; an unknown
    # mode, and any executor but the dense one in fleet mode, still raise
    for mode in ("ring", "packed"):
        mix = TG.make_mixer(top, mode, frac=0.25)
        assert mix.wire_mode == mode and getattr(mix, "wire_codec",
                                                 None) is None
    with pytest.raises(ValueError, match="unknown gossip mode"):
        TG.make_mixer(top, "star")
    for mode in ("ring", "packed"):
        with pytest.raises(ValueError, match="fleet mode") as got:
            tapi.build(tapi.ExperimentSpec(fleet=True, gossip_mode=mode),
                       lambda p, b: torch.sum(p["w"]), device="cpu")
        with pytest.raises(ValueError) as want:
            japi.build(japi.ExperimentSpec(fleet=True, gossip_mode=mode),
                       lambda p, b: 0.0)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the reference's real packed codec executor, one agent per device
# ---------------------------------------------------------------------------

REAL_EXECUTOR = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.api import ExperimentSpec, build_engine

    mesh = jax.make_mesh((4,), ("data",))
    data = dict(np.load(sys.argv[1]))
    tree = {k: data[k] for k in ("a", "b", "c")}
    y = {k: jax.device_put(v, NamedSharding(
        mesh, P("data", *([None] * (v.ndim - 1))))) for k, v in tree.items()}
    q = jax.tree_util.tree_map(jnp.zeros_like, y)
    key = jax.random.PRNGKey(7)
    out = {}
    for name, comp, kw in (("topk", "block_top_k", dict(frac=0.25)),
                           ("qsgd", "qsgd",
                            dict(compressor_kwargs={"levels": 7}))):
        spec = ExperimentSpec(n_agents=4, topology="erdos_renyi",
                              topology_weights="best_constant",
                              topology_p=0.8, topology_seed=1,
                              compressor=comp, gossip_mode="packed",
                              wire="packed_bits", comm_backend="ref", **kw)
        eng = build_engine(spec, mesh=mesh)
        c, wc = jax.jit(lambda k, a, b, e=eng: e.exchange(k, a, b))(key, y, q)
        for k in tree:
            out[f"{name}_c_{k}"] = np.asarray(c[k])
            out[f"{name}_wc_{k}"] = np.asarray(wc[k])
    # the executor's qsgd draws: leaf j of agent i packs with
    # fold_in(split(key, L)[j], i), the uniforms drawn in its window shape
    keys = jax.random.split(key, len(tree))
    rows = []
    for j, k in enumerate(sorted(tree)):
        nb = -(-int(np.prod(tree[k].shape[1:])) // 2048)
        for i in range(4):
            rows.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(keys[j], i), (nb, 2048))))
    out["noise"] = np.concatenate(rows)
    np.savez(sys.argv[2], **out)
    print("real-executor-ok")
""")


def test_exchange_equals_the_reference_real_packed_executor(tmp_path):
    tree = _tree(3, n=4)
    np.savez(tmp_path / "tree.npz", **tree)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", REAL_EXECUTOR, str(tmp_path / "tree.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        env=env, timeout=300)
    assert "real-executor-ok" in run.stdout, run.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    top = TM.make_topology("erdos_renyi", 4, weights="best_constant", p=0.8,
                           seed=1)
    for name, codec, noise in (
            ("topk", TWF.make_wire_format("block_top_k", frac=0.25), None),
            ("qsgd", TWF.make_wire_format("qsgd", levels=7),
             torch.from_numpy(ref["noise"]))):
        mix = TG.make_mixer(top, "packed", codec=codec)
        c, wc = mix.exchange(None, convert.to_torch(tree, "cpu"), noise=noise)
        for k in tree:
            np.testing.assert_allclose(c[k].numpy(), ref[f"{name}_c_{k}"],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(wc[k].numpy(), ref[f"{name}_wc_{k}"],
                                       rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# PORTER-GC under packed_bits against the reference's codec law
# ---------------------------------------------------------------------------

def _spec_kw(**over):
    return dict(PAPER_GRAPH, algo="porter-gc", eta=0.05, tau=1.0, **over)


@functools.lru_cache(maxsize=None)
def reference_codec_trajectory(model):
    """``ROUNDS`` reference PORTER-GC steps with dense gossip of the top-k
    codec's round trip: ``compress_fn`` = the per-agent pack / unpack, so
    c = unpack(pack(delta)) and wc = W c, the packed executor's law."""
    (loss_j, _), params, data = PROBLEMS[model]()
    codec = JWF.make_wire_format("top_k", frac=PAPER_GRAPH["frac"])
    ralgo = japi.build(japi.ExperimentSpec(**_spec_kw()), loss_j,
                       compress_fn=lambda key, tree: oracle_c(codec, tree))
    step = jax.jit(ralgo.step)
    state = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params))
    batches = _batches(data, ROUNDS)
    states = [state]
    for t, batch in enumerate(batches):
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                        _round_key(t))
        states.append(state)
    return states, batches, ralgo.gamma


def _port(model, **over):
    (_, loss_t), _, _ = PROBLEMS[model]()
    spec = tapi.ExperimentSpec(**_spec_kw(wire="packed_bits",
                                          gossip_mode="packed", **over))
    return tapi.build(spec, loss_t, device="cpu")


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_porter_gc_teacher_forced_equals_the_codec_law(model):
    states, batches, gamma = reference_codec_trajectory(model)
    talgo = _port(model)
    assert talgo.gamma == gamma
    for t in range(ROUNDS):
        new, _ = talgo.step(convert.state_to_torch(states[t], "cpu"),
                            convert.to_torch(batches[t], "cpu"), None)
        _assert_state(new, states[t + 1], atol=1e-5)


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_porter_gc_free_running_equals_the_codec_law(model):
    states, batches, _ = reference_codec_trajectory(model)
    talgo = _port(model)
    state = convert.state_to_torch(states[0], "cpu")
    for t in range(ROUNDS):
        state, _ = talgo.step(state, convert.to_torch(batches[t], "cpu"),
                              None)
    _assert_state(state, states[ROUNDS], atol=1e-4, fields=("x",))


# ---------------------------------------------------------------------------
# the port's own invariants (exact)
# ---------------------------------------------------------------------------

def _port_run(steps, chunk, comp="qsgd", seed=5, **over):
    kw = dict(compressor_kwargs={"levels": 7}) if comp == "qsgd" else {}
    talgo = _port("logreg", compressor=comp, **kw, **over)
    _, params, data = PROBLEMS["logreg"]()
    source = minibatch_source(*data, batch=8, device="cpu")
    state = talgo.init(convert.to_torch(params, "cpu"))
    mets = []
    state, _ = run_chunked(talgo, source, state, seed, steps, chunk=chunk,
                           on_chunk=lambda t0, t1, s, m: mets.append(m))
    return state, {k: torch.cat([m[k] for m in mets]) for k in mets[0]}


def _assert_equal_runs(a, b):
    (sa, ma), (sb, mb) = a, b
    for field in FIELDS:
        for k, leaf in getattr(sa, field).items():
            other = getattr(sb, field)[k]
            assert leaf.dtype == other.dtype, (field, k)
            assert torch.equal(leaf, other), (field, k)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


@pytest.mark.parametrize("plane", [None, "bf16"])
@pytest.mark.parametrize("comp", ["top_k", "qsgd"])
def test_kernel_backend_equals_ref_backend_exactly(comp, plane):
    """Both backends run the plain codecs on the CPU and draw the same
    words in the same order (SR words, then the codec's noise)."""
    _assert_equal_runs(
        _port_run(8, 4, comp, comm_backend="kernel", plane_dtype=plane),
        _port_run(8, 4, comp, comm_backend="ref", plane_dtype=plane))


def test_chunking_does_not_change_the_trajectory():
    one = _port_run(9, 1)
    _assert_equal_runs(one, _port_run(9, 4))
    other_seed = _port_run(9, 4, seed=6)
    assert not torch.equal(one[0].x["w"], other_seed[0].x["w"])


@pytest.mark.parametrize("comp,kw", [("top_k", dict(frac=0.05)),
                                     ("qsgd", dict(compressor_kwargs={
                                         "levels": 7}))])
def test_wire_bytes_are_measured_and_equal_the_reference(comp, kw):
    spec_kw = dict(n_agents=10, compressor=comp, gossip_mode="packed",
                   wire="packed_bits", **kw)
    eng = tapi.build_engine(tapi.ExperimentSpec(**spec_kw))
    ref = japi.build_engine(japi.ExperimentSpec(**spec_kw),
                            mesh=jax.make_mesh((1,), ("data",)))
    tree = _tree(4, n=10)
    got = eng.wire_bytes(convert.to_torch(tree, "cpu"))
    assert got == eng.wire_bytes_model(convert.to_torch(tree, "cpu"))
    assert got == ref.wire_bytes(jax.tree_util.tree_map(jnp.asarray, tree))
    assert got == ref.wire_bytes_model(
        jax.tree_util.tree_map(jnp.asarray, tree))
    assert eng.wire_bytes(50_890, 10) == ref.wire_bytes(50_890, 10)
    # what one exchange actually packed
    eng.exchange(torch.Generator().manual_seed(0),
                 convert.to_torch(tree, "cpu"),
                 convert.to_torch(jax.tree_util.tree_map(np.zeros_like, tree),
                                  "cpu"))
    assert eng.mixer.shipped_nbytes == got

"""The model axis without processes: the leaf specs, the sharded draws and
layouts, the shard-local compressor and the window count against the JAX
package, the refusals, and the reference's own model-sharded step.

* ``leaf_specs(bundle)`` equals the reference's
  ``launch.steps.abstract_init(bundle)`` PartitionSpecs (and the leaves'
  shapes) for all ten smoke configs and full-width tinyllama;
* a sharded init holds the one-card parameters' slices, bitwise;
* per-shard compression (``launch.steps.make_shard_local_compress``) is
  bitwise the reference's compressor on each shard slice;
* ``CommRound._packed_windows`` on a ``(data 2, model 2)`` layout equals
  the reference's ``CommRound._packed_windows``;
* Mamba2's packed ``w_in`` and its conv keep the reference's contiguous
  blocks on each rank at M 2 and 4 (the forward gathers them at use);
* a dimension the axis does not divide or a head split across kv groups
  raises; every decentralized algorithm, remat and a randomized codec
  pass the group check (their runs: ``tests/test_torch_tp_algos.py``);
* the reference's ``build_train_step`` on a ``(data 2, model 2)`` mesh of
  4 fake CPU devices raises ``Mapped away dimension ...`` on its first
  step (ROADMAP queue 3, faults of the reference), so the tensor-parallel
  port is held against the reference's unsharded loss and gradient
  (``tests/test_torch_tp_train.py``) instead.
"""

import dataclasses
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as RC
from repro.core.comm_round import CommRound as JCommRound
from repro.core.compression import make_compressor as jmake_compressor
from repro.launch.steps import abstract_init
from repro.models import build_model as jbuild_model
from repro.nn.module import prepend_axis_specs as jprepend
from repro_torch import api
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.agents import local_rows, model_shard
from repro_torch.core.comm_round import CommRound
from repro_torch.core.compression import make_compressor
from repro_torch.kernels import flatten as FL
from repro_torch.launch import steps
from repro_torch.launch.mesh import AgentGroup
from repro_torch.models import build_model
from repro_torch.models.model import vocab_parallel
from repro_torch.nn.module import Spec, leaf_specs, prepend_axis_specs
from repro_torch.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]


def fake_group(model_size=2, model_index=0, index=0, n_agents=2):
    return types.SimpleNamespace(
        model_size=model_size, model_index=model_index, index=index,
        n_agents=n_agents, axes=("data",),
        rows=lambda full, r=None: full[index:index + 1])


def _reference_specs(jcfg):
    shapes, specs = abstract_init(jbuild_model(jcfg))
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    return leaves, [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]


@pytest.mark.parametrize("arch", ARCHS + ["tinyllama-1.1b:full"])
def test_leaf_specs_are_the_reference(arch):
    name, full = arch.split(":")[0], arch.endswith(":full")
    jcfg = RC.get_config(name) if full else RC.get_smoke(name)
    tcfg = get_config(name) if full else get_smoke(name)
    want, shapes = _reference_specs(jcfg)
    got = tree_leaves(leaf_specs(build_model(tcfg, device="cpu")))
    assert [s.entries for s in got] == [tuple(s) for s in want]
    assert [s.shape for s in got] == shapes


def test_vocab_rule_is_the_reference():
    """Vocab-parallel embedding and head when the vocab divides by 16."""
    for arch in ARCHS:
        cfg = get_smoke(arch)
        specs = leaf_specs(build_model(cfg, device="cpu"))
        want = ("model", None) if cfg.vocab % 16 == 0 else (None, "model")
        assert specs["embed"]["table"].entries == want
        assert vocab_parallel(cfg) == (cfg.vocab % 16 == 0)
    assert not vocab_parallel(get_config("minicpm3-4b"))     # 73,448


def test_prepend_axis_specs_puts_the_agent_axes_first():
    specs = {"w": Spec(None, "model", shape=(3, 4))}
    got = prepend_axis_specs(specs, ("pod", "data"))["w"]
    assert got.entries == (("pod", "data"), None, "model")
    assert got.model_dim == 2 and got.shape == (3, 4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("m", [0, 1])
def test_sharded_init_holds_the_one_card_slices(arch, m):
    cfg = get_smoke(arch)
    one = build_model(cfg, device="cpu")
    tp = build_model(cfg, device="cpu", group=fake_group(model_index=m))
    full = one.init(torch.Generator().manual_seed(0))
    mine = tp.init(torch.Generator().manual_seed(0))
    specs = leaf_specs(one)
    for a, b, s in zip(tree_leaves(full), tree_leaves(mine),
                       tree_leaves(specs)):
        assert torch.equal(model_shard(a, s.model_dim, m, 2), b)


@pytest.mark.parametrize("leaf", ["w_in", "conv_w", "conv_b"])
@pytest.mark.parametrize("size", [2, 4])
def test_packed_mamba_leaves_keep_the_reference_blocks(leaf, size):
    """zamba2's smoke ``w_in`` (552 columns: z 256 | x 256 | B 16 | C 16 |
    dt 8) and its conv (288 channels: x | B | C): rank m holds columns
    ``[m w / M, (m + 1) w / M)`` of the one-card leaf, a slice that cuts
    across the fields, as the reference's ``(None, 'model')`` spec
    shards it."""
    cfg = get_smoke("zamba2-7b")
    full = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))["mamba"]["blk"]
    width = {"w_in": 552, "conv_w": 288, "conv_b": 288}[leaf]
    for m in range(size):
        tp = build_model(cfg, device="cpu", group=fake_group(
            model_size=size, model_index=m))
        blk = tp.init(torch.Generator().manual_seed(0))["mamba"]["blk"]
        got = blk["w_in"]["w"] if leaf == "w_in" else blk[leaf]
        want = full["w_in"]["w"] if leaf == "w_in" else full[leaf]
        lo, w = m * width // size, width // size
        assert got.shape[-1] == w
        assert torch.equal(got, want[..., lo:lo + w])


def test_a_dimension_the_model_axis_does_not_divide_raises():
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), d_ff=354)
    with pytest.raises(ValueError, match=r"layers/ffn/w_gate/w.*354"):
        build_model(cfg, device="cpu", group=fake_group(model_size=4))
    # 6 q heads over 2 ranks, 3 a rank, read 2 kv heads' groups of 2
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), n_heads=6,
                              n_kv_heads=3, head_dim=32)
    with pytest.raises(ValueError, match="n_kv_heads % M"):
        build_model(cfg, device="cpu", group=fake_group(model_size=2))


def test_a_tensor_parallel_bundle_does_not_serve():
    tp = build_model(get_smoke("tinyllama-1.1b"), device="cpu",
                     group=fake_group())
    with pytest.raises(ValueError, match="one card"):
        tp.forward({}, {})


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_recurrent_and_encdec_bundles_train_but_do_not_serve(arch):
    """rwkv6, the hybrid and the encoder-decoder build on a model axis
    (their ``loss`` is the family builder's) and refuse every serving
    entry."""
    tp = build_model(get_smoke(arch), device="cpu", group=fake_group())
    assert tp.loss.__qualname__.split(".")[0] == {
        "rwkv6-7b": "_build_rwkv", "zamba2-7b": "_build_hybrid",
        "seamless-m4t-medium": "_build_encdec"}[arch]
    for entry in (tp.forward, tp.prefill, tp.init_cache, tp.decode_step):
        with pytest.raises(ValueError, match="one card"):
            entry({}, {})


@pytest.mark.parametrize("comp", ["top_k", "block_top_k"])
@pytest.mark.parametrize("shape,dim", [((64, 352), 1), ((352, 128), 0),
                                       ((3, 2, 4096), 2), ((512,), 0)])
def test_per_shard_compression_is_the_reference_on_each_slice(comp, shape,
                                                              dim):
    full = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    fn = steps.make_shard_local_compress(make_compressor(comp, frac=0.05))
    jcomp = jmake_compressor(comp, frac=0.05)
    for m in range(2):
        part = np.ascontiguousarray(model_shard(torch.from_numpy(full), dim,
                                                m, 2).numpy())
        got = fn(None, {"w": torch.from_numpy(part)[None]})["w"][0]
        want = np.asarray(jcomp(None, jnp.asarray(part)[None]))[0]
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32))


def test_shard_local_compression_refuses_a_random_compressor():
    with pytest.raises(ValueError, match="deterministic"):
        steps.make_shard_local_compress(make_compressor("random_k",
                                                        frac=0.05))


def test_shard_local_on_one_card_joins_the_shards():
    specs = {"a": Spec(None, "model", shape=(4, 6)),
             "b": Spec(None, shape=(5,))}
    tree = {"a": torch.randn(2, 4, 6), "b": torch.randn(2, 5)}
    fn = steps.make_shard_local_compress(make_compressor("top_k", frac=0.2))
    got = steps.shard_local_on_one_card(fn, specs, 2)(None, tree)
    for m in range(2):
        part = fn(None, {"a": tree["a"][:, :, 3 * m:3 * m + 3]})["a"]
        assert torch.equal(got["a"][:, :, 3 * m:3 * m + 3], part)
    assert torch.equal(got["b"], fn(None, {"b": tree["b"]})["b"])


class _Mesh:
    shape = {"data": 2, "model": 2}


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_windows_are_the_reference(arch):
    """Windows per (leaf x model shard), a replicated leaf once: the
    port's count of a rank's block equals the reference's of the whole
    tree on a (data 2, model 2) mesh."""
    n = 2
    jshapes, jspecs = abstract_init(jbuild_model(RC.get_smoke(arch)))
    jtree = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((n,) + s.shape, jnp.float32), jshapes)
    comp = jmake_compressor("top_k", frac=0.05)
    jeng = JCommRound(compressor=comp, mixer=None, mesh=_Mesh(),
                      leaf_specs=jprepend(jspecs, "data"),
                      agent_axes=("data",))
    want = jeng._packed_windows(jtree, n)
    specs = leaf_specs(build_model(get_smoke(arch), device="cpu"))
    sharded = FL.sharded_spec(fake_group(), prepend_axis_specs(specs,
                                                               "data"))
    eng = CommRound(make_compressor("top_k", frac=0.05), mixer=None,
                    sharded=sharded)
    block = tree_map(lambda s: torch.zeros((1,) + tuple(
        d // 2 if i == s.model_dim else d for i, d in enumerate(s.shape))),
        specs)
    assert eng._packed_windows(block) == want
    assert CommRound(make_compressor("top_k", frac=0.05),
                     mixer=None)._packed_windows(block) < want


def test_block_cuts_the_one_card_plane():
    """A rank's per-shard plane of an all-agents plane: its agent row, its
    shard of each sharded leaf, the replicated leaves whole, repadded."""
    specs = {"a": Spec("data", None, "model", shape=(3, 8000)),
             "b": Spec("data", None, shape=(700,))}
    tree = {"a": torch.randn(2, 3, 8000), "b": torch.randn(2, 700)}
    for index in range(2):
        for m in range(2):
            g = fake_group(index=index, model_index=m)
            sharded = FL.sharded_spec(g, specs)
            mine = {"a": tree["a"][index:index + 1, :,
                                   4000 * m:4000 * (m + 1)],
                    "b": tree["b"][index:index + 1]}
            local = FL.flat_spec(mine)
            full = FL.to_planes(tree, FL.flat_spec(tree))
            assert sharded.global_layout(local).plane_shape == full.shape
            assert torch.equal(sharded.block(full, local),
                               FL.to_planes(mine, local))
            assert sharded.counted() == [True, m == 0]


def test_local_rows_keeps_the_shard_of_the_one_card_draw():
    g = fake_group(index=1, model_index=1)
    draw = lambda shape: torch.randn(  # noqa: E731
        shape, generator=torch.Generator().manual_seed(7))
    full = draw((2, 3, 8))
    assert torch.equal(local_rows(g, (1, 3, 4), draw, dim=2),
                       full[1:2, :, 4:8])
    assert torch.equal(local_rows(g, (1, 3, 8), draw), full[1:2])


def test_agent_group_grid_with_a_model_axis():
    g = AgentGroup(index=1, sizes=(2, 2), axes=("data", "model"),
                   device="cpu", backend="gloo", staged=False,
                   model_index=1)
    assert (g.axes, g.sizes, g.model_size) == (("data",), (2,), 2)
    assert g.rank == 3
    assert g.neighbour(+1) == 0 and g._rank_of(0) == 1
    g = AgentGroup(index=3, sizes=(2, 2, 4), axes=("pod", "data", "model"),
                   device="cpu", backend="gloo", staged=False,
                   model_index=2)
    assert g.n_agents == 4 and g.rank == 14 and g.model_size == 4
    assert g.coords() == {"pod": 1, "data": 1}
    one = AgentGroup(index=1, sizes=(4,), axes=("data",), device="cpu",
                     backend="gloo", staged=False)
    assert one.model_size == 1 and one.rank == 1
    with pytest.raises(ValueError, match="no model axis"):
        one.all_reduce_sum(torch.zeros(1), axis="model")
    with pytest.raises(ValueError):
        AgentGroup(index=0, sizes=(2,), axes=("data",), device="cpu",
                   backend="gloo", staged=False, model_size=2,
                   model_index=2)


def _model_axis_specs():
    return prepend_axis_specs(leaf_specs(build_model(get_smoke(
        "tinyllama-1.1b"), device="cpu")), "data")


@pytest.mark.parametrize("algo", ["dsgd", "choco", "porter-adam", "clip21",
                                  "subgrad-comp"])
def test_algorithms_outside_the_porter_family_refuse_a_model_axis(algo):
    """They refused a model axis until every decentralized algorithm was
    ported there: now ``build`` hands them the per-shard layout (dsgd's
    step, which has no engine, takes it itself)."""
    group = fake_group()
    spec = api.ExperimentSpec(algo=algo, n_agents=2, topology="ring",
                              gossip_mode="ring")
    assert api._check_group(spec, group) is None
    built = api.build(spec, lambda p, b: p, device="cpu", group=group,
                      leaf_specs=_model_axis_specs())
    sharded = (built.step.keywords["sharded"] if algo == "dsgd"
               else built.engine.sharded)
    assert sharded is not None and sharded.group is group


def test_model_axis_refuses_remat_and_a_random_codec():
    """remat and a qsgd codec ran on one card only until this slice of
    item 12(c): now they pass the group check, and the codec's process
    executor is told each leaf's model shards (its per-shard draw); a
    model axis without the leaves' specs still raises."""
    group = fake_group()
    assert api._check_group(api.ExperimentSpec(
        n_agents=2, remat_policy="full"), group) is None
    spec = api.ExperimentSpec(n_agents=2, wire="packed_bits",
                              gossip_mode="ring", compressor="qsgd")
    assert api._check_group(spec, group) is None
    engine = api.build_engine(spec, group=group,
                              leaf_specs=_model_axis_specs())
    assert engine.sharded is not None and engine.mixer.wire_codec is not None
    with pytest.raises(ValueError, match="leaf_specs"):
        api._sharded(group, None)


@pytest.mark.parametrize("model_size", [2, 4])
def test_sharded_layout_counts_each_leaf_shards(model_size):
    """``ShardedFlatSpec.shards()``: the model axis's size for a sharded
    leaf and 1 for a replicated one, the one list that the wire bytes,
    dsgd's replica count and the codec's draw read."""
    sharded = api._sharded(fake_group(model_size=model_size),
                           _model_axis_specs())
    dims = sharded.dims()
    assert None in dims and any(d is not None for d in dims)
    assert sharded.shards() == [1 if d is None else model_size
                                for d in dims]


def test_qsgd_draw_layout_is_agent_then_shard_then_window():
    """``gossip.draw_blocks`` cuts one global draw leaf by leaf into
    (agent, model shard, window) blocks, and a rank keeps its agent's
    block of its shard (of the one shard of a replicated leaf)."""
    from repro_torch.core import gossip as G
    from repro_torch.core.wire_formats import PACK_BLOCK
    nbs, shards, n = [3, 2], [2, 1], 3
    rows = G.draw_rows(n, nbs, shards)
    assert rows == n * (3 * 2 + 2 * 1)
    full = torch.arange(rows * PACK_BLOCK, dtype=torch.float32).reshape(
        rows, PACK_BLOCK)
    blocks = G.draw_blocks(full, n, nbs, shards)
    assert [tuple(b.shape) for b in blocks] == [(3, 2, 3, PACK_BLOCK),
                                                (3, 1, 2, PACK_BLOCK)]
    assert torch.equal(blocks[0][1, 1, 0], full[(1 * 2 + 1) * 3])
    assert torch.equal(blocks[1][2, 0, 1], full[18 + 2 * 2 + 1])
    group = fake_group(model_size=2, model_index=1, index=1, n_agents=3)
    assert torch.equal(G._rank_windows(full, group, nbs, shards),
                       torch.cat([full[9:12], full[20:22]]))


@pytest.mark.parametrize("module", ["nn/tensor_parallel.py",
                                    "launch/mesh.py", "launch/steps.py",
                                    "kernels/flatten.py", "core/agents.py",
                                    "nn/attention.py", "nn/moe.py",
                                    "nn/ssm.py",
                                    "models/blocks.py", "models/model.py",
                                    "core/push_sum.py"])
def test_model_axis_modules_import_no_jax(module):
    import ast
    path = ROOT / "src" / "repro_torch" / module
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}


_REFERENCE_STEP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.launch import shapes as SH
from repro.launch.steps import build_train_step
mesh = jax.make_mesh((2, 2), ("data", "model"))
setup = build_train_step(get_smoke("tinyllama-1.1b"), mesh,
                         SH.ShapeSpec("smoke", 16, 4, "train"),
                         comm_backend="ref")
state = jax.device_put(setup.init_state(jax.random.PRNGKey(0)),
                       setup.state_shardings)
batch = jax.device_put({"tokens": jnp.zeros((2, 2, 16), jnp.int32)},
                       setup.batch_shardings)
try:
    setup.jitted(state, batch, jax.random.PRNGKey(1))
    print("STEP RAN")
except ValueError as e:
    print("VALUEERROR:", e)
"""


def test_reference_model_sharded_step_raises():
    """The reference's tinyllama smoke step on a (data 2, model 2) mesh of
    4 fake CPU devices, its state and batch placed with the step's own
    shardings: the first jitted step raises under jax 0.9.0."""
    out = subprocess.run([sys.executable, "-c", _REFERENCE_STEP],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("VALUEERROR: Mapped away dimension of inputs passed to vmap "
            "should be sharded the same") in out.stdout, out.stdout

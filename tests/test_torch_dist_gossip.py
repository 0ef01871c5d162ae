"""The gossip executors across processes (one agent a rank, gloo on the
CPU) against the port's one-card executors, and the ``(pod, data)`` grid
against the reference's two-axis ring.

Each rank runs ``tests/torch_dist_worker.py`` (spawned once per world
size by :func:`repro_torch.launch.mesh.spawn_agents`, one CPU thread a
rank): it builds every agent's inputs from a seed, runs the one-card
executor on all of them and the executor across processes on its own row,
and reports.  The one-card executors are held against the reference's
``shard_map`` executors by ``tests/test_torch_gossip_executors.py``, so
bitwise here reaches the reference too.  Held here:

* bitwise, at 2 and 4 ranks, f32 and bf16, a static ring and the
  ``rotate:ring/metropolis+ring/lazy`` schedule: the dense, ring, plain
  packed, ring codec and packed codec executors (top-k and qsgd codecs),
  their ``push`` / ``exchange_ps`` and the push-sum weight;
* exact: the bytes a rank ships against ``gossip_wire_bytes`` (each leaf
  padding its own windows) or the codec's byte model, and the engine's
  accounting under the group; the collectives a rank issues within the
  executor's ``GossipBudget``;
* bitwise: bf16, int16 and int32 tensors through a shift and an
  all-gather (the byte views);
* bitwise: the 2 x 2 ``(pod, data)`` grid's ring and ring codec against the
  one-card ring, and against the reference's two-axis ring on 4 fake CPU
  devices compiled op by op (``--xla_backend_optimization_level=0``);
* the refusals, and a failing or hanging rank failing the spawn.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro_torch import api
from repro_torch.core import gossip as G
from repro_torch.core import mixing as M
from repro_torch.launch import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 120
CASES = [(n, name, dt, sched) for n in (4, 2) for name in W.EXECUTORS
         for dt in W.DTYPES for sched in ("static", "sched")]
IDS = ["-".join(map(str, c)) for c in CASES]

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.core import gossip as G, mixing as M, wire_formats as WF

    data = dict(np.load(sys.argv[1]))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("pod", "data"))
    axes = ("pod", "data")
    w = M.make_topology("ring", 4).w
    codec = WF.make_wire_format("top_k", frac=0.25)
    out = {}
    for dt in ("f32", "bf16"):
        tree = {}
        for k in "abc":
            v = jnp.asarray(data[k], jnp.dtype(
                "float32" if dt == "f32" else "bfloat16"))
            tree[k] = jax.device_put(v, NamedSharding(
                mesh, P(axes, *([None] * (v.ndim - 1)))))
        ring = jax.jit(G.make_ring_mixer(w, mesh, agent_axes=axes))(tree)
        _, wc = jax.jit(G.make_ring_codec_mixer(
            w, mesh, codec, agent_axes=axes).exchange)(
                jax.random.PRNGKey(7), tree)
        for k in "abc":
            for name, res in (("ring", ring), ("ring_codec_topk", wc)):
                a = np.asarray(res[k])
                out[f"{name}_{dt}_{k}"] = a.view(
                    {2: np.uint16, 4: np.uint32}[a.dtype.itemsize])
    np.savez(sys.argv[2], **out)
    print("reference-two-axis-ok")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's reports at 4 and 2 ranks and on the 2 x 2 grid, and the
    reference's two-axis ring (its subprocess runs beside the spawns)."""
    tmp = tmp_path_factory.mktemp("dist")
    tree = W.global_tree(4, torch.float32, 3)
    np.savez(tmp / "in.npz", **{k: v.numpy() for k, v in tree.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    out = {n: mesh.spawn_agents(W.gossip_cases, n, device="cpu",
                                threads=1, timeout_s=SPAWN_TIMEOUT) for n in (4, 2)}
    out["grid"] = mesh.spawn_agents(W.grid_ring, 4, grid=(2, 2),
                                    device="cpu", threads=1,
                                    timeout_s=SPAWN_TIMEOUT)
    stdout, stderr = ref.communicate(timeout=SPAWN_TIMEOUT)
    assert "reference-two-axis-ok" in stdout, stderr[-3000:]
    out["reference"] = dict(np.load(tmp / "ref.npz"))
    return out


def _reports(runs, n, name, dt, sched):
    return [rank[(name, dt, sched)] for rank in runs[n]]


@pytest.mark.parametrize("n,name,dt,sched", CASES, ids=IDS)
def test_executor_is_the_one_card_executor_bitwise(runs, n, name, dt, sched):
    for r, rep in enumerate(_reports(runs, n, name, dt, sched)):
        for tag, got in rep.items():
            assert got["bitwise"], (r, tag)
        # the push-sum weight rides every executor but the plain packed one
        assert ("push" in rep) == (name != "packed")


@pytest.mark.parametrize("n,name,dt,sched", CASES, ids=IDS)
def test_shipped_bytes_are_the_model(runs, n, name, dt, sched):
    for r, rep in enumerate(_reports(runs, n, name, dt, sched)):
        for tag, got in rep.items():
            assert got["shipped"] == got["model"], (r, tag, got)
            if got["engine"] is not None:
                assert got["engine"] == got["shipped"], (r, tag, got)


@pytest.mark.parametrize("n,name,dt,sched", CASES, ids=IDS)
def test_collectives_within_the_budget(runs, n, name, dt, sched):
    mode = W.EXECUTORS[name][0]
    want = "collective-permute" if mode == "ring" else "all-gather"
    for r, rep in enumerate(_reports(runs, n, name, dt, sched)):
        for tag, got in rep.items():
            assert got["within_budget"], (r, tag, got["census"])
            # one message for all leaves: a shift a live band, or one
            # all-gather
            shifts = 1 if n == 2 else 2
            assert got["census"] == {want: shifts if mode == "ring" else 1}


@pytest.mark.parametrize("n", [4, 2])
def test_byte_views_round_trip_bf16_int16_int32(runs, n):
    for rank in runs[n]:
        rt = rank["roundtrip"]
        assert rt["shift"] and rt["gather"]
        assert rt["dtypes"] == ["torch.bfloat16", "torch.int16",
                                "torch.int32"]


@pytest.mark.parametrize("name", ["ring", "ring_codec_topk"])
@pytest.mark.parametrize("dt", list(W.DTYPES))
def test_pod_data_grid_is_the_one_card_ring(runs, name, dt):
    coords = [rank["coords"] for rank in runs["grid"]]
    assert coords == [{"pod": p, "data": d} for p in (0, 1) for d in (0, 1)]
    for rank in runs["grid"]:
        assert rank["equal"][(name, dt)]


@pytest.mark.parametrize("name", ["ring", "ring_codec_topk"])
@pytest.mark.parametrize("dt", list(W.DTYPES))
def test_pod_data_grid_is_the_reference_two_axis_ring(runs, name, dt):
    """The reference's seam patch (two shifts an axis, ``jnp.where`` at the
    seam) and the port's global-ring shifts give the same bits."""
    ref = runs["reference"]
    for i, rank in enumerate(runs["grid"]):
        for k, got in rank["rows"][(name, dt)].items():
            want = ref[f"{name}_{dt}_{k}"][i:i + 1]
            np.testing.assert_array_equal(
                got.numpy().view(want.dtype), want, err_msg=f"{i} {k}")


def _group(n=4, axes=("data",), sizes=None):
    return mesh.AgentGroup(index=0, sizes=sizes or (n,), axes=axes,
                           device="cpu", backend="gloo", staged=False)


def test_transport_rule():
    assert mesh.transport_for(torch.device("cpu"), 4) == ("gloo", False)
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="NCCL refuses two ranks"):
            mesh.transport_for(torch.device("cuda"), 4, backend="nccl")
        assert mesh.transport_for(torch.device("cuda"), 4) == ("gloo", True)
    with pytest.raises(ValueError, match="unsupported backend"):
        mesh.transport_for(torch.device("cpu"), 4, backend="mpi")


def test_grid_coordinates_and_neighbours():
    group = mesh.AgentGroup(index=2, sizes=(2, 2), axes=("pod", "data"),
                            device="cpu", backend="gloo", staged=False)
    assert group.n_agents == 4 and group.coords() == {"pod": 1, "data": 0}
    assert [group.neighbour(d) for d in (1, -1)] == [3, 1]
    assert [group.neighbour(d, "data") for d in (1, -1)] == [3, 3]
    assert [group.neighbour(d, "pod") for d in (1, -1)] == [0, 0]
    with pytest.raises(ValueError, match="agent axes"):
        mesh.AgentGroup(index=0, sizes=(4,), axes=("model",), device="cpu",
                        backend="gloo", staged=False)


def test_ring_refuses_a_schedule_off_the_ring_under_a_group():
    sched = M.erdos_renyi_schedule(4, p=0.8, period=4)
    with pytest.raises(ValueError, match="not circulant ring bands"):
        G.make_mixer(sched, "ring", group=_group())
    with pytest.raises(ValueError, match="one agent a rank"):
        G.make_mixer(M.make_topology("ring", 5), "ring", group=_group())


def _params():
    return {"w": torch.zeros(123), "b": torch.zeros(())}


@pytest.mark.parametrize("algo", ["dp-sgd", "soteriafl"])
def test_server_algorithms_refuse_a_group(algo):
    """Since the server algorithms run with one client a rank, a group
    builds them: ``init`` hands out the server's replica and, for
    SoteriaFL, this client's row of the shifts.  Any other client count
    is refused."""
    spec = api.ExperimentSpec(algo=algo, n_agents=4)
    state = api.build(spec, W.logreg_loss, device="cpu",
                      group=_group()).init(_params())
    assert state.x["w"].shape == (123,)
    if algo == "soteriafl":
        assert state.h["w"].shape == (1, 123)
    with pytest.raises(ValueError, match="one agent a rank"):
        api.build(spec.replace(n_agents=10), W.logreg_loss, device="cpu",
                  group=_group())


def test_fleet_and_agent_count_refuse_a_group():
    """Since the fleet axis shards over processes, a group builds a fleet
    of n = 4 k agents and ``init`` hands out the rank's k rows; a build
    without the fleet still takes one agent a rank."""
    state = api.build(api.ExperimentSpec(n_agents=8, fleet=True),
                      W.logreg_loss, device="cpu", group=_group()).init(
                          _params())
    assert state.x["w"].shape == (2, 123) and state.v["b"].shape == (2,)
    with pytest.raises(ValueError, match="one agent a rank"):
        api.build(api.ExperimentSpec(n_agents=10), W.logreg_loss,
                  device="cpu", group=_group())


def test_one_card_executors_carry_the_reference_budgets():
    top = M.make_topology("ring", 4)
    codec = W._codec(("top_k", {"frac": 0.25}))
    got = {(mode, c is not None): G.make_mixer(top, mode, frac=0.25,
                                               codec=c).budget
           for mode in ("ring", "packed") for c in (None, codec)}
    assert got[("ring", False)].per_leaf == {"collective-permute": 2}
    assert got[("ring", True)].per_leaf == {"collective-permute": 4}
    assert got[("packed", False)].per_leaf == {"all-gather": 2}
    assert got[("packed", True)].per_leaf == {"all-gather": 2}
    dense = G.make_mixer(top, "dense").budget
    assert dense.per_leaf == {} and dense.spmd_dependent


def test_a_failing_rank_fails_the_spawn():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        mesh.spawn_agents(W.fail_on_rank_one, 3, device="cpu", threads=1,
                          timeout_s=SPAWN_TIMEOUT)


def test_a_hanging_rank_is_killed_at_the_timeout():
    with pytest.raises(RuntimeError, match="did not finish within"):
        mesh.spawn_agents(W.hang_on_rank_zero, 2, device="cpu", threads=1,
                          timeout_s=3)

"""Rank programs of the fleet and server-algorithm process tests (not a
test module).

``tests/test_torch_dist_fleet.py`` and ``tests/test_torch_dist_server.py``
start their ranks with :func:`repro_torch.launch.mesh.spawn_agents`, which
imports this module by name in each rank.  It imports only
``repro_torch``, ``numpy`` and ``torch``.  Every rank builds the same global
inputs, runs the port's one-card path on all of them and the path across
processes on its own rows, and reports; the reference's draws and states
arrive as numpy arrays (the test files make them with ``repro``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import api, data
from repro_torch.core import clipping
from repro_torch.core import fleet as F
from repro_torch.core import gossip as G
from repro_torch.core import mixing as M
from repro_torch.core.agents import local_rows
from repro_torch.launch import runtime
from repro_torch.models import paper
from repro_torch.tree import tree_leaves, tree_map

from torch_dist_worker import bitwise

# ---------------------------------------------------------------------------
# the fleet axis over processes
# ---------------------------------------------------------------------------

D, B = 24, 4
FLEET_ROUNDS = 5
FLEET_SIGMA = 0.01
# tests/test_fleet.py's SHARD_SCRIPT: its problem and spec
SHARD = dict(algo="porter-gc", topology="ring", compressor="top_k",
             frac=0.25, eta=0.1, tau=5.0, gossip_mode="dense", fleet=True)
# case -> (n agents, spec overrides); every case runs 4 ranks.  "shard"
# is SHARD_SCRIPT's problem (the same batch every round); the others draw
# minibatches from a synthetic dataset through minibatch_source
FLEET_CASES = {
    "shard n8 k2": (8, {}),
    "porter-gc n4 k1": (4, {}),
    "porter-dp n8 k2 rotate": (8, dict(algo="porter-dp",
                                       sigma_p=FLEET_SIGMA,
                                       topology_schedule="rotate:ring+star")),
    "dp-csgp n8 k2": (8, dict(algo="dp-csgp", sigma_p=FLEET_SIGMA)),
    "porter-gc n1024 exponential": (1024, dict(topology="exponential")),
    "clip21 n1024 exponential": (1024, dict(algo="clip21",
                                            topology="exponential")),
    "porter-dp n1024 exponential": (1024, dict(algo="porter-dp",
                                               sigma_p=FLEET_SIGMA,
                                               topology="exponential")),
    "porter-gc n1024 er schedule": (
        1024, dict(topology_schedule="erdos_renyi:period=4")),
    "clip21 n1024 er schedule": (
        1024, dict(algo="clip21", topology_schedule="erdos_renyi:period=4")),
    "porter-dp n1024 er schedule": (
        1024, dict(algo="porter-dp", sigma_p=FLEET_SIGMA,
                   topology_schedule="erdos_renyi:period=4")),
}
# mixer -> a fleet table at 16 agents; "coo" ones force the COO slots
FLEET_MIXERS = ("dense static", "dense schedule", "coo static",
                "coo schedule")


def logreg_loss(params, batch):
    f, l = batch
    f, l = torch.atleast_2d(f), torch.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


def shard_problem():
    """SHARD_SCRIPT's batch, an ``(8, 4, 24)`` feature stack and its labels,
    and its zero parameters, as numpy."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=D)
    f = rng.normal(size=(8, B, D)).astype(np.float32)
    l = (f @ w_true > 0).astype(np.float32)
    return f, l


def fleet_spec(name: str) -> api.ExperimentSpec:
    n, over = FLEET_CASES[name]
    return api.ExperimentSpec(n_agents=n, **{**SHARD, **over})


def _fleet_data(n: int):
    rng = np.random.default_rng(n)
    w_true = rng.normal(size=D)
    xs = rng.normal(size=(n, 16, D)).astype(np.float32)
    return xs, (xs @ w_true > 0).astype(np.float32)


def _x(state):
    return state.base.x if hasattr(state, "base") else state.x


def _tensors(state):
    return [leaf for leaf in tree_leaves(state)
            if isinstance(leaf, torch.Tensor)]


def _noise(state_x, n: int, t: int):
    """Round t's injected N(0, 1) draws at the one-card gradient's shape."""
    rng = np.random.default_rng(1000 + t)
    return {k: torch.from_numpy(rng.standard_normal(
        (n,) + tuple(v.shape[1:])).astype(np.float32))
        for k, v in state_x.items()}


def _fleet_run(algo, spec, source, rounds: int):
    """``rounds`` steps of ``algo`` from zero parameters: the state, the
    per-round metrics (numpy) and the collectives of the rank's group."""
    state = algo.init({"w": torch.zeros(D), "b": torch.zeros(())})
    group = algo.group
    if group is not None:
        group.census.clear()
    metrics = []
    for t in range(rounds):
        g_batch, g_step = runtime.round_generators(0, t, "cpu")
        kw = {}
        if api.algorithm_info(spec.algo).dp:
            kw["noise"] = _noise(_x(state), spec.n_agents, t)
        state, m = algo.step(state, source(g_batch, t), g_step, **kw)
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    census = None if group is None else dict(group.census)
    return state, metrics, census


def _fleet_case(group, name: str):
    spec = fleet_spec(name)
    n = spec.n_agents
    if name.startswith("shard"):
        f, l = map(torch.from_numpy, shard_problem())

        def one_src(gen, t):
            return f, l

        def proc_src(gen, t):
            return group.rows(f), group.rows(l)
    else:
        xs, ys = _fleet_data(n)
        one_src = data.minibatch_source(xs, ys, B, device="cpu")
        proc_src = data.minibatch_source(xs, ys, B, device="cpu",
                                         group=group)
    one = api.build(spec, logreg_loss, device="cpu")
    proc = api.build(spec, logreg_loss, device="cpu", group=group)
    s1, m1, _ = _fleet_run(one, spec, one_src, FLEET_ROUNDS)
    s2, m2, census = _fleet_run(proc, spec, proc_src, FLEET_ROUNDS)
    full = runtime.gather_state(s2, group)
    mixes = proc.info.comm_rounds * FLEET_ROUNDS
    return dict(
        rows=tree_leaves(_x(s2))[0].shape[0], state_bitwise=bitwise(s1, full),
        block_bitwise=bitwise([group.rows(a) for a in _tensors(s1)],
                              _tensors(s2)),
        metrics_one=m1, metrics_proc=m2, census=census, mixes=mixes,
        budget=proc.mixer.budget.per_leaf,
        shipped=proc.mixer.shipped_nbytes,
        gathered=([leaf.numpy() for leaf in _tensors(full)]
                  if name.startswith("shard") else None))


def _fleet_table(kind: str):
    if kind == "dense static":
        return M.make_topology("ring", 16), None
    if kind == "dense schedule":
        return M.rotating_schedule(["ring", "star"], 16), None
    if kind == "coo static":
        return F.fleet_topology("exponential", 16), 0
    return F.fleet_er_schedule(16, period=4), 0


def _mixer_cases(group):
    """Every fleet mixer at 16 agents (4 a rank): a mix and a push of
    seeded f32 and bf16 trees against the one-card mixer's rows, round 3
    of a schedule.  -> {kind: bitwise}."""
    out = {}
    for kind in FLEET_MIXERS:
        table, gate = _fleet_table(kind)
        kw = {} if gate is None else {"dense_gate": gate}
        one = F.make_fleet_mixer(table, **kw)
        proc = F.make_fleet_mixer(table, group=group, **kw)
        rng = np.random.default_rng(7)
        tree = {"a": torch.from_numpy(rng.standard_normal(
                    (16, 5, 3)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(
                    (16, 9)).astype(np.float32)).to(torch.bfloat16)}
        wvec = torch.from_numpy(rng.random(16).astype(np.float32))
        t = 3 if one.time_varying else None
        want = G.apply_mixer(one, tree, t)
        got = G.apply_mixer(proc, tree_map(group.rows, tree), t)
        pw_tree, pw = one.push(tree, wvec, t)
        pg_tree, pg = proc.push(tree_map(group.rows, tree),
                                group.rows(wvec), t)
        out[kind] = (bitwise(tree_map(group.rows, want), got)
                     and bitwise(tree_map(group.rows, pw_tree), pg_tree)
                     and bitwise(group.rows(pw), pg))
    return out


def _dense_census(group):
    """The dense process executor's collectives for one mix (one agent a
    rank): the fleet's census is held to it."""
    top = M.make_topology("ring", group.n_agents)
    mix = G.make_mixer(top, "dense", group=group)
    group.census.clear()
    mix({"a": torch.ones(1, 3), "b": torch.ones(1)})
    return dict(group.census)


def _block_draws(group):
    """``local_rows`` and ``minibatch_source`` with k = 2 rows a rank:
    each the rank's block of the one-card draw.  -> {site: bitwise}."""
    n = 2 * group.n_agents
    gen1, gen2 = (torch.Generator().manual_seed(3) for _ in range(2))
    full = torch.randn((n, 5), generator=gen1)
    mine = local_rows(group, (2, 5), lambda shape: torch.randn(
        shape, generator=gen2))
    xs, ys = _fleet_data(n)
    one = data.minibatch_source(xs, ys, B, device="cpu")
    proc = data.minibatch_source(xs, ys, B, device="cpu", group=group)
    g1, _ = runtime.round_generators(0, 2, "cpu")
    g2, _ = runtime.round_generators(0, 2, "cpu")
    return {"local_rows": torch.equal(full[2 * group.index:
                                           2 * group.index + 2], mine),
            "minibatch_source": bitwise(tree_map(group.rows, one(g1, 2)),
                                        proc(g2, 2))}


def fleet_cases(group):
    """Every FLEET_CASES run, the mixers, the census of the dense process
    executor and the block draws.  -> {name: report}."""
    out = {name: _fleet_case(group, name) for name in FLEET_CASES}
    out["mixers"] = _mixer_cases(group)
    out["dense census"] = _dense_census(group)
    out["draws"] = _block_draws(group)
    return out


# ---------------------------------------------------------------------------
# the server algorithms with clients as processes
# ---------------------------------------------------------------------------

SERVER_ROUNDS = 5
SERVER_BATCH = 8
SERVER_SIGMA = 0.01
# case -> spec overrides; "mask" cases take an injected random_k mask
# (build(compress_fn=)), "drawn" ones draw it from the round's generator
SERVER_CASES = {
    "dp-sgd f32": dict(algo="dp-sgd"),
    "dp-sgd f32 chunked": dict(algo="dp-sgd"),
    "soteriafl top_k f32": dict(algo="soteriafl"),
    "soteriafl top_k bf16": dict(algo="soteriafl", plane_dtype="bf16"),
    "soteriafl random_k mask f32": dict(algo="soteriafl",
                                        compressor="random_k", frac=0.2),
    "soteriafl random_k drawn f32": dict(algo="soteriafl",
                                         compressor="random_k", frac=0.2),
}
# a chunked case's SAMPLE_PLANE_BYTES: 3 samples of the MLP's 7 tiles
# from each of 4 ranks a gather (chunks of 3, 3 and 2 of a rank's 8), 12
# samples a chunk on one card (12, 12 and 8 of 32): no chunk of one sample,
# whose gradient a vmap of one takes otherwise than a vmap of several
CHUNK_BYTES = 4 * 3 * 7 * 8192 * 4


def server_spec(name: str, n: int):
    return {**dict(n_agents=n, compressor="top_k", frac=0.05, eta=0.2,
                   tau=1.0, sigma_p=SERVER_SIGMA, alpha_shift=0.5),
            **SERVER_CASES[name]}


def server_problem(n: int):
    """Every round's batch (numpy, ``(n, b, 784)`` and ``(n, b)``) and the
    MLP's initial parameters."""
    x, y = data.mnist_like(num=2000, seed=0)
    xs, ys = data.shard_to_agents(x, y, n)
    rng = np.random.default_rng(3)
    rows = np.arange(n)[:, None]
    batches = []
    for _ in range(SERVER_ROUNDS):
        idx = rng.integers(0, xs.shape[1], (n, SERVER_BATCH))
        batches.append((xs[rows, idx], ys[rows, idx]))
    params = {k: v.numpy() for k, v in
              paper.mlp_init(seed=0, device="cpu").items()}
    return batches, params


def _masked(masks, clock, rows):
    """A ``compress_fn`` that keeps the coordinates of round
    ``clock["t"]``'s mask (``rows`` picks this process's rows)."""
    def compress(gen, tree):
        del gen
        m = masks[clock["t"]]
        return {k: torch.where(rows(torch.from_numpy(m[k])), leaf,
                               torch.zeros_like(leaf))
                for k, leaf in tree.items()}
    return compress


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _np(tree):
    return tree_map(lambda t: t.float().numpy() if t.dtype == torch.bfloat16
                    else t.numpy(), tree)


def _server_run(algo, batches, params, noises, clock, rows):
    """SERVER_ROUNDS steps from ``params``: the state, the per-round
    metrics and the state's fields after every round (numpy)."""
    state = algo.init(_torch(params))
    metrics, states = [], []
    for t in range(SERVER_ROUNDS):
        clock["t"] = t
        _, g_step = runtime.round_generators(0, t, "cpu")
        batch = tree_map(rows, _torch(batches[t]))
        state, m = algo.step(state, batch, g_step, noise=_torch(noises[t]))
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
        states.append({f: _np(getattr(state, f)) for f in state._fields
                       if f != "step"})
    return state, metrics, states


def _server_case(group, name: str, inj):
    n = group.n_agents
    spec = api.ExperimentSpec(**server_spec(name, n))
    batches, params = server_problem(n)
    loss = paper.mlp_loss()
    masks, noises = inj["masks"], inj["noise"]
    clock = {"t": 0}
    group.census.clear()
    if "chunked" in name:
        clipping.SAMPLE_PLANE_BYTES = CHUNK_BYTES
    try:
        runs = {}
        for label, g in (("one", None), ("proc", group)):
            rows = (lambda a: a) if g is None else group.rows
            kw = {}
            if masks is not None:
                kw["compress_fn"] = _masked(masks, clock, rows)
            algo = api.build(spec, loss, device="cpu", group=g, **kw)
            runs[label] = _server_run(algo, batches, params, noises, clock,
                                      rows)
    finally:
        clipping.SAMPLE_PLANE_BYTES = 4 << 30
    (s1, m1, _), (s2, m2, states) = runs["one"], runs["proc"]
    same = bitwise(s1.x, s2.x)
    if hasattr(s1, "h"):
        same = (same and bitwise(s1.h_bar, s2.h_bar)
                and bitwise(tree_map(group.rows, s1.h), s2.h))
    return dict(state_bitwise=same, x=_np(s2.x), metrics_one=m1,
                metrics_proc=m2, census=dict(group.census), states=states,
                h_rows=tree_leaves(s2.h)[0].shape[0]
                if hasattr(s2, "h") else None)


def server_cases(group, injected):
    """Every SERVER_CASES run over the group's ranks, one client a rank,
    against the one-card port; ``injected[name]``: ``{"noise": per-round
    N(0, 1) draws at the one-card shape, "masks": per-round random_k masks
    or None}``."""
    return {name: _server_case(group, name, injected[name])
            for name in SERVER_CASES}

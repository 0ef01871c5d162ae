"""Rank programs of the agents-as-processes tests (not a test module).

``tests/test_torch_dist_gossip.py`` and ``tests/test_torch_dist_train.py``
start their ranks with :func:`repro_torch.launch.mesh.spawn_agents`, which
imports this module by name in each rank.  It imports only ``repro_torch``,
``numpy`` and ``torch``: never ``jax``, ``repro`` or a test file.  Every
rank builds the same global inputs from a seed, runs the port's one-card
path on them and the path across processes on its own row, and reports
what agreed; the test files assert on the reports.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import gossip as G
from repro_torch.core import mixing as M
from repro_torch.core import wire_formats as WF
from repro_torch.core.comm_round import CommRound
from repro_torch.core.compression import make_compressor
from repro_torch.core.porter import average_params
from repro_torch.tree import tree_leaves, tree_map

# leaves that pad separately: 77 -> 1 window, 2100 -> 2, a scalar -> 1
SHAPES = {"a": (7, 11), "b": (2100,), "c": ()}
SCHEDULE = "rotate:ring/metropolis+ring/lazy"
FRAC = 0.25
# executor -> (gossip mode, codec: None or (compressor, kwargs))
EXECUTORS = {
    "dense": ("dense", None),
    "ring": ("ring", None),
    "packed": ("packed", None),
    "ring_codec_topk": ("ring", ("top_k", {"frac": FRAC})),
    "ring_codec_qsgd": ("ring", ("qsgd", {"levels": 7})),
    "packed_codec_topk": ("packed", ("top_k", {"frac": FRAC})),
    "packed_codec_qsgd": ("packed", ("qsgd", {"levels": 7})),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of ``t`` (so -0.0 and NaNs compare exactly)."""
    t = t.contiguous()
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16, torch.int16):
        return t.view(torch.int16)
    return t


def _same(x, y) -> bool:
    if not isinstance(x, torch.Tensor):
        return x == y                           # a round counter
    return (x.shape == y.shape and x.dtype == y.dtype
            and torch.equal(bits(x), bits(y)))


def bitwise(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(_same(x, y) for x, y in zip(la, lb))


def global_tree(n: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal((n,) + s)
                                .astype(np.float32)).to(dtype)
            for k, s in SHAPES.items()}


def _topology(n: int, sched: str):
    spec = api.ExperimentSpec(n_agents=n, topology="ring",
                              topology_weights="metropolis",
                              topology_schedule=(SCHEDULE if sched == "sched"
                                                 else None))
    top = api.resolve_topology(spec)
    schedule = api.resolve_schedule(spec, top)
    return top if schedule is None else schedule


def _codec(kind):
    if kind is None:
        return None
    name, kw = kind
    return WF.make_wire_format(name, **kw)


def _engine(name, mixer, dt):
    kind = EXECUTORS[name][1]
    comp = (make_compressor("top_k", frac=FRAC) if kind is None
            else make_compressor(kind[0], **kind[1]))
    return CommRound(compressor=comp, mixer=mixer,
                     plane_dtype=None if dt == "f32" else torch.bfloat16)


def _within_budget(census, budget, n_leaves: int) -> bool:
    return all(cat in budget.per_leaf
               and count <= budget.per_leaf[cat] * n_leaves
               for cat, count in census.items())


def _model_bytes(name, eng, mine, n: int, dt: str, push: bool) -> float:
    """The byte model of one exchange: ``gossip_wire_bytes`` per leaf (each
    leaf pads its own windows) plus 4 bytes an agent's weight, or the
    codec's layout model."""
    mode = EXECUTORS[name][0]
    if EXECUTORS[name][1] is not None:
        return eng.wire_bytes_model(mine, push_sum=push)
    db = 4 if dt == "f32" else 2
    sizes = [leaf[0].numel() for leaf in tree_leaves(mine)]
    if mode == "packed":
        body = sum(G.gossip_wire_bytes("packed", n, d, FRAC, db)
                   for d in sizes)
    else:
        body = G.gossip_wire_bytes(mode, n, sum(sizes), FRAC, db)
    if not push:
        return body
    links = n if mode == "dense" else (1 if n == 2 else 2)
    return body + 4.0 * links


def gossip_cases(group):
    """Every executor, f32 and bf16, static and scheduled: the one-card
    executor on all agents' inputs against the executor across processes
    on this rank's row.  -> {case: report}."""
    n, out = group.n_agents, {}
    for name, (mode, kind) in EXECUTORS.items():
        codec = _codec(kind)
        for dt in DTYPES:
            for sched in ("static", "sched"):
                top = _topology(n, sched)
                one = G.make_mixer(top, mode, frac=FRAC, codec=codec)
                proc = G.make_mixer(top, mode, frac=FRAC, codec=codec,
                                    group=group)
                tree = global_tree(n, DTYPES[dt], 3)
                mine = tree_map(group.rows, tree)
                dw = torch.from_numpy(np.random.default_rng(5).standard_normal(
                    n).astype(np.float32))
                t = 3 if sched == "sched" else None
                rep = {}
                for push in (False, True):
                    if push and mode == "packed" and codec is None:
                        continue                 # no weight slot
                    group.census.clear()
                    if codec is not None:
                        g1 = torch.Generator().manual_seed(11)
                        g2 = torch.Generator().manual_seed(11)
                        if push:
                            want = one.exchange_ps(g1, tree, dw, t)
                            got = proc.exchange_ps(g2, mine, group.rows(dw),
                                                   t)
                        else:
                            want = one.exchange(g1, tree, t)
                            got = proc.exchange(g2, mine, t)
                        want = tuple(tree_map(group.rows, w) for w in want)
                    elif push:
                        want = one.push(tree, dw, t)
                        got = proc.push(mine, group.rows(dw), t)
                        want = tuple(tree_map(group.rows, w) for w in want)
                    else:
                        want = tree_map(group.rows,
                                        G.apply_mixer(one, tree, t))
                        got = G.apply_mixer(proc, mine, t)
                    census = dict(group.census)
                    eng = _engine(name, proc, dt)
                    tag = "push" if push else "mix"
                    rep[tag] = dict(
                        bitwise=bitwise(want, got), census=census,
                        within_budget=_within_budget(
                            census, proc.budget, len(SHAPES)),
                        shipped=proc.shipped_nbytes,
                        model=_model_bytes(name, eng, mine, n, dt, push),
                        engine=(eng.wire_bytes(mine, push_sum=push)
                                if mode != "dense" else None))
                out[(name, dt, sched)] = rep
    out["roundtrip"] = _roundtrip(group)
    return out


def _roundtrip(group):
    """bf16, int16 and int32 tensors through a shift and an all-gather:
    every byte arrives as the sender's."""
    def mine(i):
        rng = np.random.default_rng(100 + i)
        return [torch.from_numpy(rng.standard_normal((3, 5)).astype(
                    np.float32)).to(torch.bfloat16),
                torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, 7,
                                              dtype=np.int16)),
                torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (2, 2),
                                              dtype=np.int32))]
    n, i = group.n_agents, group.index
    got = group.shift(mine(i), +1)
    gathered = group.all_gather(mine(i))
    ok_shift = bitwise(got, mine((i - 1) % n))
    ok_gather = all(bitwise([g[j] for g in gathered], mine(j))
                    for j in range(n))
    return dict(shift=ok_shift, gather=ok_gather,
                dtypes=[str(t.dtype) for t in got])


def grid_ring(group):
    """The ring executors on this rank's row of the (pod, data) grid
    against the one-card ring: -> {case: bitwise} and this rank's outputs
    (for the reference's two-axis ring)."""
    n, out, rows = group.n_agents, {}, {}
    for name in ("ring", "ring_codec_topk"):
        mode, kind = EXECUTORS[name]
        codec = _codec(kind)
        for dt in DTYPES:
            top = _topology(n, "static")
            one = G.make_mixer(top, mode, codec=codec)
            proc = G.make_mixer(top, mode, codec=codec, group=group)
            tree = global_tree(n, DTYPES[dt], 3)
            mine = tree_map(group.rows, tree)
            if codec is None:
                want = tree_map(group.rows, one(tree))
                got = proc(mine)
            else:
                gen = torch.Generator().manual_seed(11)
                want = tree_map(group.rows, one.exchange(gen, tree)[1])
                got = proc.exchange(gen, mine)[1]
            out[(name, dt)] = bitwise(want, got)
            rows[(name, dt)] = {k: bits(v) for k, v in got.items()}
    return dict(equal=out, rows=rows, coords=group.coords())


# ---------------------------------------------------------------------------
# training across processes (tests/test_torch_dist_train.py)
# ---------------------------------------------------------------------------

ROUNDS = 20
DP_SIGMA = 0.01
# case -> (problem, spec overrides); every case runs 4 agents
TRAIN = {
    "porter-gc dense (quickstart)": (
        "logreg", dict(algo="porter-gc", topology="erdos_renyi",
                       topology_weights="best_constant", topology_p=0.8,
                       topology_seed=1, eta=0.05)),
    "porter-dp ring (mlp)": (
        "mlp", dict(algo="porter-dp", gossip_mode="ring", eta=0.2,
                    sigma_p=DP_SIGMA)),
    "dp-csgp ring codec (mlp)": (
        "mlp", dict(algo="dp-csgp", gossip_mode="ring", wire="packed_bits",
                    topology_schedule="directed:ring_skips", eta=0.2,
                    sigma_p=DP_SIGMA)),
    "choco ring bf16 (mlp)": (
        "mlp", dict(algo="choco", gossip_mode="ring", plane_dtype="bf16",
                    eta=0.2)),
}


def logreg_loss(params, batch):
    f, label = batch
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * label - 1) * logits)))


def _problem(kind: str, n: int):
    from repro_torch import data
    from repro_torch.models import paper
    if kind == "logreg":
        x, y = data.a9a_like(num=2000, dim=123, seed=0)
        params = {"w": torch.zeros(123), "b": torch.zeros(())}
        loss = logreg_loss
    else:
        x, y = data.mnist_like(num=2000, seed=0)
        params = paper.mlp_init(seed=0, device="cpu")
        loss = paper.mlp_loss()
    xs, ys = data.shard_to_agents(x, y, n)
    return xs, ys, params, loss


def _run(algo, source, params, rounds):
    from repro_torch.launch import runtime
    state = algo.init(params)
    per_round = []
    state, _ = runtime.run_chunked(
        algo, source, state, 0, rounds, chunk=5,
        on_chunk=lambda t0, t1, st, m: per_round.append(
            {k: v.numpy().copy() for k, v in m.items()}))
    metrics = {k: np.concatenate([m[k] for m in per_round])
               for k in per_round[0]}
    return state, metrics


def train_cases(group):
    """Each TRAIN case for ROUNDS rounds on all agents in this process and
    with one agent a rank: -> {case: the two runs' metrics, whether the
    gathered final state is bitwise, its largest |x diff|}."""
    from repro_torch import data
    from repro_torch.launch import runtime
    n, out = group.n_agents, {}
    for name, (kind, over) in TRAIN.items():
        xs, ys, params, loss = _problem(kind, n)
        spec = api.ExperimentSpec(
            n_agents=n, **{"topology": "ring",
                           "topology_weights": "metropolis", **over},
            compressor="top_k", frac=0.05, tau=1.0, comm_backend="kernel")
        one = api.build(spec, loss, device="cpu")
        proc = api.build(spec, loss, device="cpu", group=group)
        s1, m1 = _run(one, data.minibatch_source(xs, ys, 8, device="cpu"),
                      params, ROUNDS)
        s2, m2 = _run(proc, data.minibatch_source(xs, ys, 8, device="cpu",
                                                  group=group),
                      params, ROUNDS)
        full = runtime.gather_state(s2, group)
        x1, x2 = tree_leaves(s1.x if hasattr(s1, "x") else s1.base.x), \
            tree_leaves(full.x if hasattr(full, "x") else full.base.x)
        avg1 = tree_leaves(average_params(s1.x))
        avg2 = tree_leaves(average_params(s2.x, group))
        out[name] = dict(
            metrics_one=m1, metrics_proc=m2,
            state_bitwise=bitwise(s1, full),
            x_diff=max(float((a - b).abs().max()) for a, b in zip(x1, x2)),
            x_scale=max(float(a.abs().max()) for a in x1),
            avg_diff=max(float((a - b).abs().max())
                         for a, b in zip(avg1, avg2)),
            loss_bitwise=bool(np.array_equal(m1["loss"], m2["loss"])))
    return out


def _draw_sites(group):
    """Every random draw site, one-card against this rank's rows: ->
    {site: bitwise}."""
    from repro_torch import data
    from repro_torch.configs import get_smoke
    from repro_torch.core import clipping
    from repro_torch.core.compression import low_rank, qsgd, random_k
    from repro_torch.launch import runtime
    n, i, out = group.n_agents, group.index, {}

    def gens(t):
        return runtime.round_generators(0, t, "cpu")

    xs, ys, params, loss = _problem("mlp", n)
    one = data.minibatch_source(xs, ys, 8, device="cpu")
    mine = data.minibatch_source(xs, ys, 8, device="cpu", group=group)
    out["batch indices"] = all(
        bitwise(tree_map(group.rows, one(gens(t)[0], t)), mine(gens(t)[0], t))
        for t in range(3))
    cfg = get_smoke("paligemma-3b")
    lm1 = data.batch_source(cfg, n, 2, 16, device="cpu")
    lm2 = data.batch_source(cfg, n, 2, 16, device="cpu", group=group)
    out["lm tokens and patches"] = bitwise(
        tree_map(group.rows, lm1(gens(0)[0], 0)), lm2(gens(0)[0], 0))
    # the DP noise: a zero loss clips to 0, so the gradient is sigma * z
    zero = lambda p, b: sum(torch.sum(v * 0.0) for v in tree_leaves(p))
    x1 = tree_map(lambda p: p.unsqueeze(0).expand((n,) + p.shape).clone(),
                  params)
    batch = one(gens(0)[0], 0)
    g1, _ = clipping.dp_gradient(zero, x1, batch, 1.0, 0.5, gen=gens(0)[1],
                                 agents="stacked")
    g2, _ = clipping.dp_gradient(zero, tree_map(group.rows, x1),
                                 tree_map(group.rows, batch), 1.0, 0.5,
                                 gen=gens(0)[1], agents="stacked",
                                 group=group)
    out["dp noise"] = bitwise(tree_map(group.rows, g1), g2)
    rows = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, 3000)).astype(np.float32))
    for name, comp in (("qsgd dither", qsgd(7)), ("random_k mask",
                                                 random_k(0.1)),
                       ("low_rank sketch", low_rank(2))):
        a = comp(gens(1)[1], rows)
        b = comp(gens(1)[1], group.rows(rows), group=group)
        out[name] = bitwise(group.rows(a), b)
    top = _topology(n, "static")
    eng1 = CommRound(compressor=qsgd(7), mixer=G.make_mixer(top, "ring"))
    eng2 = CommRound(compressor=qsgd(7),
                     mixer=G.make_mixer(top, "ring", group=group))
    trees = [global_tree(n, torch.bfloat16, s) for s in (1, 2, 3)]
    w1 = eng1.sr_draw(gens(2)[1], trees)
    w2 = eng2.sr_draw(gens(2)[1], [tree_map(group.rows, t) for t in trees])
    tiles = w1[0].shape[0] // n
    out["sr words"] = all(torch.equal(a[i * tiles:(i + 1) * tiles], b)
                          for a, b in zip(w1, w2))
    out["codec noise"] = _codec_noise_rows(group)
    return out


def _codec_noise_rows(group) -> bool:
    """The qsgd codec's noise: this rank's windows of the one-card draw
    (a codec that records its noise operand)."""
    n, seen = group.n_agents, {}
    base = WF.make_wire_format("qsgd", levels=7)

    def recording(tag):
        def pack(rows, noise=None):
            seen[tag] = noise
            return base.pack(rows, noise)
        return WF.WireFormat(base.name, base.deterministic,
                             base.payload_bytes_per_window,
                             base.overhead_bytes_per_window, pack,
                             base.unpack)
    top = _topology(n, "static")
    tree = global_tree(n, torch.float32, 4)
    G.make_mixer(top, "ring", codec=recording("one")).exchange(
        torch.Generator().manual_seed(2), tree)
    G.make_mixer(top, "ring", codec=recording("proc"), group=group).exchange(
        torch.Generator().manual_seed(2), tree_map(group.rows, tree))
    nbs = [-(-leaf[0].numel() // WF.PACK_BLOCK) for leaf in
           tree_leaves(tree)]
    return torch.equal(G._rank_windows(seen["one"], group, nbs), seen["proc"])


def lm_cases(group):
    """The LM smoke config through ``build_train_step(group=)``, 2 rounds,
    against all agents in this process; and every draw site."""
    from repro_torch import data
    from repro_torch.configs import get_smoke
    from repro_torch.launch import runtime, steps
    n = group.n_agents
    cfg = get_smoke("tinyllama-1.1b")
    runs = {}
    for label, g in (("one", None), ("proc", group)):
        setup = steps.build_train_step(cfg, n, compressor_name="top_k",
                                       eta=3e-2, gossip_mode="ring",
                                       plane_dtype="bf16", device="cpu",
                                       group=g)
        state = setup.init_state(torch.Generator().manual_seed(0))
        source = data.batch_source(cfg, n, 2, 16, device="cpu", group=g)
        losses = []
        state, _ = runtime.run_chunked(
            setup.algorithm, source, state, 0, 2, chunk=1,
            on_chunk=lambda t0, t1, st, m: losses.append(
                float(m["loss"][0])))
        runs[label] = (state if g is None
                       else runtime.gather_state(state, group), losses)
    (s1, l1), (s2, l2) = runs["one"], runs["proc"]
    x1, x2 = tree_leaves(s1.x), tree_leaves(s2.x)
    return dict(
        losses_one=l1, losses_proc=l2,
        x_diff=max(float((a - b).abs().max()) for a, b in zip(x1, x2)),
        state_bitwise=bitwise(s1, s2), draws=_draw_sites(group))


def fail_on_rank_one(group):
    """Rank 1 raises; the others wait for it at a barrier."""
    if group.index == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def hang_on_rank_zero(group):
    """Rank 0 never returns."""
    if group.index == 0:
        import time
        time.sleep(600)


def train_all(group):
    """:func:`train_cases` and :func:`lm_cases` in one spawn."""
    return {"train": train_cases(group), "lm": lm_cases(group)}


def loaded_roots(group):
    """The forbidden packages this rank has imported (none)."""
    import sys
    return sorted({m.split(".")[0] for m in sys.modules}
                  & {"jax", "jaxlib", "repro", "ml_dtypes"})

"""Rank programs of the model-axis tests (not a test module).

``tests/test_torch_tp_train.py``, ``tests/test_torch_tp_m4.py``,
``tests/test_torch_tp_families*.py``, ``tests/test_torch_tp_recurrent*.py``
and ``tests/test_torch_tp_algos*.py`` start their ranks on a ``(data,
model)`` grid with :func:`repro_torch.launch.mesh.spawn_agents`
(``model=M``), which imports this module by name in each rank.  It
imports only ``repro_torch``, ``numpy`` and ``torch``.  Every rank builds the same global inputs from a
seed, runs the port's one-card path on them and the tensor-parallel path
on its own block, and reports what it saw; the test files assert.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch import api, data
from repro_torch.configs import get_smoke
from repro_torch.core import clipping
from repro_torch.core import wire_formats as WF
from repro_torch.core.agents import model_shard
from repro_torch.core.comm_round import CommRound
from repro_torch.core.compression import make_compressor
from repro_torch.core.gossip import make_codec_compress
from repro_torch.kernels import flatten as FL
from repro_torch.launch import runtime, steps
from repro_torch.models import build_model
from repro_torch.nn import tensor_parallel as TP
from repro_torch.nn.module import leaf_specs, prepend_axis_specs
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

ETA = 3e-2
BATCH, SEQ = 2, 16


def smoke(arch: str = "tinyllama-1.1b", **over):
    """The f32 smoke config (with ``over``)."""
    return dataclasses.replace(get_smoke(arch), dtype=torch.float32,
                               remat=False, **over)


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.int16):
        return t.view(torch.int16)
    return t


def _specs(cfg):
    return leaf_specs(build_model(cfg, device="cpu"))


def _shard(tree, specs, group, stacked: bool):
    """This rank's block of a one-card tree (agent rows too if stacked)."""
    off = 1 if stacked else 0
    return tree_map(lambda a, s: model_shard(
        group.rows(a) if stacked else a,
        None if s.model_dim is None else s.model_dim + off,
        group.model_index, group.model_size).contiguous(), tree, specs)


def _max_rel(got, want):
    """Per leaf max |got - want| / max |want|, the largest."""
    out = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        out = max(out, float((a - b).abs().max()) / (scale or 1.0))
    return out


def _max_abs(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _normwise(got, want):
    """||got - want|| / ||want|| over every leaf, in f64."""
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    num = sum(float(torch.sum((a.double() - b.double()) ** 2))
              for a, b in pairs)
    return (num / sum(float(torch.sum(b.double() ** 2))
                      for _, b in pairs)) ** 0.5


def _replicated_bitwise(group, tree, specs) -> bool:
    """Whether every replicated leaf of this rank's ``tree`` is bitwise
    the other model ranks'."""
    reps = [leaf for leaf, s in zip(tree_leaves(tree), tree_leaves(specs))
            if s.model_dim is None]
    full = group.all_gather([bits(leaf) for leaf in reps], axis="model")
    return all(all(torch.equal(f[0], f[m]) for m in range(1, f.shape[0]))
               for f in full)


# ---------------------------------------------------------------------------
# the loss and gradient
# ---------------------------------------------------------------------------

def grads(group, cfg, np_params, tokens):
    """The tensor-parallel loss and this rank's gradient block, from the
    one-replica parameters ``np_params`` (numpy) and ``tokens`` (b, s),
    through the agent vmap the algorithms take."""
    return batch_grads(group, cfg, np_params, {"tokens": tokens})


def batch_grads(group, cfg, np_params, np_batch):
    """:func:`grads` for any family's batch (``np_batch``: numpy, one
    replica's ``tokens`` and a VLM's ``patches`` or an encoder-decoder's
    ``frames``)."""
    bundle = build_model(cfg, device="cpu", group=group)
    params = _shard(tree_map(torch.from_numpy, np_params), _specs(cfg),
                    group, False)
    batch = {k: torch.from_numpy(v)[None] for k, v in np_batch.items()}
    g, loss = vmap(grad_and_value(bundle.loss))(
        tree_map(lambda a: a[None], params), batch)
    return {"loss": float(loss[0]), "grads": tree_map(lambda a: a[0], g)}


# ---------------------------------------------------------------------------
# training rounds
# ---------------------------------------------------------------------------

def _setup(cfg, n, group, variant, plane, gossip, wire, local, comp,
           compress_fn=None, sigma=0.0, schedule=None):
    """The train step; with ``compress_fn`` its algorithm rebuilt with
    that compression (the one-card twin of a shard-local run)."""
    setup = steps.build_train_step(
        cfg, n, variant=variant, compressor_name=comp, eta=ETA,
        gossip_mode=gossip, plane_dtype=plane, device="cpu", group=group,
        local_compress=local, sigma_p=sigma, wire=wire,
        topology_schedule=schedule)
    if compress_fn is None:
        return setup
    return dataclasses.replace(setup, algorithm=api.build(
        setup.algorithm.spec, setup.bundle.loss, device="cpu",
        compress_fn=compress_fn))


def _run(setup, cfg, n, group, rounds):
    state = setup.init_state(torch.Generator().manual_seed(0))
    source = data.batch_source(cfg, n, BATCH, SEQ, device="cpu", group=group)
    metrics = []
    state, _ = runtime.run_chunked(
        setup.algorithm, source, state, 0, rounds, chunk=1,
        on_chunk=lambda t0, t1, st, m: metrics.append(
            {k: float(v[0]) for k, v in m.items()}))
    return state, metrics


def train(group, variant="gc", plane=None, gossip="ring", wire="dense",
          local=False, comp="top_k", rounds=1, arch="tinyllama-1.1b",
          over=(), schedule=None):
    """``rounds`` rounds of ``variant`` on the grid against all agents in
    this process (the one-card compressor: the whole-leaf one, or the
    per-shard one when ``local`` or under a codec).  Returns x's largest
    difference and the metrics, the replicated leaves' agreement across
    the model ranks, the census and the bytes shipped."""
    cfg = smoke(arch, **dict(over))
    n = group.n_agents
    specs = _specs(cfg)
    sigma = 0.05 if variant in ("dp", "csgp") else 0.0
    fn = None
    if local or wire == "packed_bits":
        base = (make_codec_compress(WF.make_wire_format(comp, frac=0.05))
                if wire == "packed_bits"
                else steps.make_shard_local_compress(
                    make_compressor(comp, frac=0.05)))
        fn = steps.shard_local_on_one_card(base, specs, group.model_size)
    one = _setup(cfg, n, None, variant, plane, "dense" if wire != "dense"
                 else gossip, "dense", False, comp, fn, sigma, schedule)
    proc = _setup(cfg, n, group, variant, plane, gossip, wire, local, comp,
                  sigma=sigma, schedule=schedule)
    s1, m1 = _run(one, cfg, n, None, rounds)
    group.census.clear()
    group.model_census.clear()
    s2, m2 = _run(proc, cfg, n, group, rounds)
    census = (dict(group.census), dict(group.model_census))
    full = runtime.gather_state(s2, group, specs)
    mixer = proc.algorithm.engine.mixer
    eng = proc.algorithm.engine
    model, rep = _byte_split(eng, s2.q_x, specs, gossip, wire, n)
    return dict(
        x_diff=_max_abs(full.x, s1.x),
        metrics_one=m1, metrics_proc=m2,
        replicated=all(_replicated_bitwise(group, getattr(s2, f), specs)
                       for f in ("x", "v", "q_x", "m_x", "q_v", "m_v",
                                 "g_prev")),
        census=census, budget=dict(mixer.budget.per_leaf),
        n_leaves=len(tree_leaves(s2.x)),
        shipped=int(mixer.shipped_nbytes), model_bytes=model,
        replicated_bytes=rep,
        windows=eng._packed_windows(s2.x),
        finite=all(bool(torch.isfinite(leaf).all())
                   for leaf in tree_leaves(s2.x)),
        **({} if not hasattr(s2, "xw") else dict(
            weights_bitwise=_weights_bitwise(group, s2),
            xw_diff=float((full.xw - s1.xw).abs().max()),
            xw_moved=float((s1.xw - 1.0).abs().max()))))


def _byte_split(eng, tree, specs, gossip, wire, n):
    """The reference's byte model of one exchange of ``tree`` (the whole
    replica: ``d`` of every whole leaf, packed windows per leaf and model
    shard) and the bytes one rank's executor ships for the replicated
    leaves alone, which every model rank ships."""
    leaves = tree_leaves(tree)
    rep = [leaf for leaf, s in zip(leaves, tree_leaves(specs))
           if s.model_dim is None]
    db = leaves[0].element_size() if eng.plane_dtype is None else 2
    links = n if gossip in ("dense", "packed") else (1 if n == 2 else 2)
    if wire == "packed_bits":
        per = WF.measured_pack_nbytes(eng.mixer.wire_codec, WF.PACK_BLOCK)
        win = sum(-(-leaf[0].numel() // WF.PACK_BLOCK) for leaf in rep)
        return float(eng.wire_bytes_model(tree)), links * win * per
    if gossip == "packed":
        k_b = WF.topk_keep(eng.mixer.wire_frac)
        win = sum(-(-leaf[0].numel() // WF.PACK_BLOCK) for leaf in rep)
        return float(eng.wire_bytes(tree)), links * win * k_b * (db + 4)
    d = sum(leaf[0].numel() * (1 if s.model_dim is None
                               else eng.sharded.group.model_size)
            for leaf, s in zip(leaves, tree_leaves(specs)))
    from repro_torch.core.gossip import gossip_wire_bytes
    return (gossip_wire_bytes(gossip, n, d, dtype_bytes=db),
            links * sum(leaf[0].numel() for leaf in rep) * db)


def train_cases(group):
    """The (data 2, model 2) cases of ``tests/test_torch_tp_train.py``."""
    out = {}
    for variant in ("gc", "dp"):
        out[variant] = train(group, variant)
    out["gc-5"] = train(group, "gc", rounds=5, plane="bf16")
    out["gc-local-block"] = train(group, "gc", local=True,
                                  comp="block_top_k")
    for gossip in ("dense", "packed"):
        out[f"gc-{gossip}"] = train(group, "gc", gossip=gossip)
    for gossip in ("ring", "packed"):
        out[f"gc-{gossip}-codec"] = train(group, "gc", gossip=gossip,
                                          wire="packed_bits")
    out["gc-chatglm3"] = train(group, "gc", arch="chatglm3-6b")
    out["gc-danube"] = train(group, "gc", arch="h2o-danube-3-4b")
    out["ef"] = ef_case(group)
    out["faults"] = fault_cases(group)
    return out


# ---------------------------------------------------------------------------
# the ef updates on per-shard planes
# ---------------------------------------------------------------------------

def _tree(cfg, n, dtype, seed):
    rng = np.random.default_rng(seed)
    return tree_map(lambda s: torch.from_numpy(rng.standard_normal(
        (n,) + s.shape).astype(np.float32)).to(dtype), _specs(cfg))


def ef_case(group):
    """``track_update`` / ``step_update`` on this rank's per-shard planes
    (bf16 EF buffers, the SR words from ``sr_draw``) against the one-card
    engine's on all agents' whole leaves: bitwise, block for block."""
    cfg = smoke()
    n, specs = group.n_agents, _specs(cfg)
    axes = group.axes[0]
    sharded = FL.sharded_spec(group, prepend_axis_specs(specs, axes))
    comp = make_compressor("top_k", frac=0.05)
    one = CommRound(comp, mixer=None, backend="kernel",
                    plane_dtype=torch.bfloat16)
    mine = dataclasses.replace(one, sharded=sharded)
    bf = torch.bfloat16
    q, m, v, c, wc, g, gp = (_tree(cfg, n, bf, s) for s in range(7))
    x = _tree(cfg, n, torch.float32, 9)
    sh = lambda t: _shard(t, specs, group, True)   # noqa: E731
    out = {}
    gen = lambda: torch.Generator().manual_seed(5)   # noqa: E731
    bits1 = one.sr_draw(gen(), (q, m, v))
    bits2 = mine.sr_draw(gen(), tuple(sh(t) for t in (q, m, v)))
    r1 = one.track_update(c, wc, v, q, m, g, gp, 0.3, sr_bits=bits1)
    r2 = mine.track_update(*(sh(t) for t in (c, wc, v, q, m, g, gp)), 0.3,
                           sr_bits=bits2)
    out["track"] = all(torch.equal(bits(a), bits(b)) for a, b in zip(
        tree_leaves([sh(t) for t in r1]), tree_leaves(list(r2))))
    bits1 = one.sr_draw(gen(), (q, m, x))
    bits2 = mine.sr_draw(gen(), tuple(sh(t) for t in (q, m, x)))
    r1 = one.step_update(c, wc, x, q, m, v, 0.3, ETA, sr_bits=bits1)
    r2 = mine.step_update(*(sh(t) for t in (c, wc, x, q, m, v)), 0.3, ETA,
                          sr_bits=bits2)
    out["step"] = all(torch.equal(bits(a), bits(b)) for a, b in zip(
        tree_leaves([sh(t) for t in r1]), tree_leaves(list(r2))))
    return out


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

class _NoModelReduce:
    """The group with its model-axis all-reduce skipped (a shard-local
    clip norm)."""

    def __init__(self, group):
        self._g = group

    def __getattr__(self, name):
        return getattr(self._g, name)

    def all_reduce_sum(self, x, axis=None):
        if axis == "model":
            return x.clone()
        return self._g.all_reduce_sum(x, axis)


def fault_cases(group):
    """Each check's reading, sound and with its fault planted: the
    cross-shard clip against the one-card clip (fault: the norm of the
    rank's shard alone), the DP noise against the one-card draw's block
    (fault: every rank's own draw at its local shape, from the same
    seed), the gradient against the one-card gradient (fault: the copy's
    backward all-reduce skipped)."""
    cfg = smoke()
    n, specs = group.n_agents, _specs(cfg)
    sharded = FL.sharded_spec(group, prepend_axis_specs(specs,
                                                        group.axes[0]))
    g = _tree(cfg, n, torch.float32, 11)
    want = _shard(clipping.stacked_clip(g, 1.0), specs, group, True)
    out = {"clip": _max_rel(clipping.stacked_clip(
        _shard(g, specs, group, True), 1.0, sharded=sharded), want)}
    bad = sharded._replace(group=_NoModelReduce(group))
    out["clip_fault"] = _max_rel(clipping.stacked_clip(
        _shard(g, specs, group, True), 1.0, sharded=bad), want)

    # the DP noise: z drawn inside dp_gradient, read back through sigma
    bundle = build_model(cfg, device="cpu")
    tp = build_model(cfg, device="cpu", group=group)
    params = bundle.init(torch.Generator().manual_seed(0))
    x1 = tree_map(lambda a: a[None].expand((n,) + a.shape).clone(), params)
    x2 = _shard(x1, specs, group, True)
    tokens = {"tokens": torch.randint(0, cfg.vocab, (n, 2, 8),
                                      generator=torch.Generator()
                                      .manual_seed(3))}
    mine_batch = tree_map(group.rows, tokens)
    sigma = 1e4       # the noise dominates the mean
    z1, _ = clipping.dp_gradient(bundle.loss, x1, tokens, 1.0, sigma,
                                 gen=torch.Generator().manual_seed(4),
                                 agents="stacked")
    z2, _ = clipping.dp_gradient(tp.loss, x2, mine_batch, 1.0, sigma,
                                 gen=torch.Generator().manual_seed(4),
                                 agents="stacked", group=group,
                                 sharded=sharded)
    want = _shard(z1, specs, group, True)
    out["noise"] = _max_rel(z2, want)
    gen = torch.Generator().manual_seed(4)
    own = tree_map(lambda a: torch.randn(a.shape, generator=gen), z2)
    out["noise_fault"] = _max_rel(
        tree_map(lambda a, z: a * 0 + sigma * z, z2, own), want)

    # the gradient, with and without the backward all-reduce
    def grad_err():
        g1, _ = vmap(grad_and_value(bundle.loss))(x1, tokens)
        g2, _ = vmap(grad_and_value(tp.loss))(x2, mine_batch)
        return _max_rel(g2, _shard(g1, specs, group, True))

    out["grad"] = grad_err()
    saved = TP._Copy.backward
    TP._Copy.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        out["grad_fault"] = grad_err()
    finally:
        TP._Copy.backward = saved
    return out


def m4_cases(group):
    """The (data 2, model 4) cases of ``tests/test_torch_tp_m4.py``."""
    over = (("n_kv_heads", 4),)
    return {"gc": train(group, "gc", over=over),
            "dp": train(group, "dp", over=over),
            "gc-local-bf16": train(group, "gc", plane="bf16", local=True,
                                   comp="block_top_k", rounds=3, over=over)}


def m1_case(group):
    """A (data 2) grid built with the model-axis code: the LM smoke
    config through ``build_train_step(group=)`` against all agents on one
    card, bitwise, with no model axis made."""
    cfg = smoke()
    n = group.n_agents
    one = _setup(cfg, n, None, "gc", "bf16", "ring", "dense", False, "top_k")
    proc = _setup(cfg, n, group, "gc", "bf16", "ring", "dense", False,
                  "top_k")
    s1, m1 = _run(one, cfg, n, None, 2)
    s2, m2 = _run(proc, cfg, n, group, 2)
    full = runtime.gather_state(s2, group)
    same = all(torch.equal(bits(a), bits(b)) for a, b in
               zip(tree_leaves(full), tree_leaves(s1))
               if isinstance(a, torch.Tensor))
    return dict(bitwise=same, model_size=group.model_size,
                axes=group.axes, sharded=proc.algorithm.engine
                .sharded is None, loss=(m1[-1]["loss"], m2[-1]["loss"]))


# ---------------------------------------------------------------------------
# the decoder families on the model axis (tests/test_torch_tp_families*.py)
# ---------------------------------------------------------------------------

# label -> (arch, config overrides): MLA, ffn- and expert-parallel MoE, the
# VLM with its one kv head split over the ranks (each smoke config tied at
# vocab 512, vocab-parallel), and the embedding layouts
FAMILIES = {
    "mla": ("minicpm3-4b", ()),
    "moe-ffn": ("grok-1-314b", ()),
    "moe-expert": ("arctic-480b", (("n_experts", 16),)),
    "vlm": ("paligemma-3b", ()),
    "tied-vocab": ("tinyllama-1.1b", (("tie_embeddings", True),)),
    "tied-dmodel": ("minicpm3-4b", (("vocab", 500),)),
    "untied-dmodel": ("tinyllama-1.1b", (("vocab", 500),)),
}


# the recurrent families and the encoder-decoder, each smoke config (f32):
# rwkv6 at 4 heads x 32, zamba2 at 8 heads x 32 and state 16 (552 w_in
# columns, the shared block twice), seamless at 4 heads and frontend 64
RECURRENT = {
    "rwkv6": ("rwkv6-7b", ()),
    "hybrid": ("zamba2-7b", ()),
    "encdec": ("seamless-m4t-medium", ()),
}


def family_of(label):
    """(arch, config overrides) of a label of :data:`FAMILIES` or
    :data:`RECURRENT`."""
    return FAMILIES[label] if label in FAMILIES else RECURRENT[label]


def family_cfg(label):
    arch, over = family_of(label)
    return smoke(arch, **dict(over))


def _weights_bitwise(group, state) -> bool:
    """Whether the push-sum weight planes are bitwise the other model
    ranks'."""
    full = group.all_gather([bits(getattr(state, f)) for f in
                             ("xw", "q_w", "m_w")], axis="model")
    return all(torch.equal(f[0], f[m]) for f in full
               for m in range(1, f.shape[0]))


def expert_combine(group, seed=5):
    """The expert-parallel MoE layer (16 experts, f32) on this rank's
    experts against the one-card layer on the same tokens: the output and
    the aux loss, bitwise or not."""
    from repro_torch.nn import moe as MO
    cfg = MO.MoeConfig(d_model=32, d_ff=48, n_experts=16, top_k=2)
    one = MO.init_moe(torch.Generator().manual_seed(seed), cfg)
    mine = {"router": one["router"],
            **{k: model_shard(one[k], 0, group.model_index,
                              group.model_size).contiguous()
               for k in ("w_gate", "w_in", "w_out")}}
    x = torch.randn((2, 24, 32), generator=torch.Generator().manual_seed(
        seed + 1))
    want, aux1 = MO.moe(one, cfg, x)
    got, aux2 = MO.moe(mine, cfg, x, group)
    return dict(bitwise=torch.equal(bits(got), bits(want)),
                aux_bitwise=torch.equal(bits(aux2), bits(aux1)),
                max_abs=float((got - want).abs().max()))


def family_cases(group, cases, variants=(), grad_inputs=None):
    """The grid's runs for :data:`FAMILIES` or :data:`RECURRENT`: each
    label of ``grad_inputs`` (``label -> (np_params, np_batch)``) through
    :func:`batch_grads`, one PORTER-GC round on the ring with the
    whole-leaf top-k for each of ``cases``, then ``variants``: ``(name,
    label, variant, gossip, wire, schedule, compressor, rounds)`` (a
    ``block_top_k`` compressor shard-local), and the expert-parallel
    combine."""
    out = {}
    for label, (np_params, np_batch) in (grad_inputs or {}).items():
        out[f"grads {label}"] = batch_grads(group, family_cfg(label),
                                            np_params, np_batch)
    for label in cases:
        arch, over = family_of(label)
        out[label] = train(group, "gc", arch=arch, over=over)
    for name, label, variant, gossip, wire, schedule, comp, rounds in (
            variants):
        arch, over = family_of(label)
        out[name] = train(group, variant, gossip=gossip, wire=wire,
                          comp=comp, arch=arch, over=over, rounds=rounds,
                          schedule=schedule, local=comp == "block_top_k")
    out["combine"] = expert_combine(group)
    return out


def recurrent_cases(group, cases, variants, grad_inputs):
    """The ``(data 2, model M)`` runs of ``tests/test_torch_tp_recurrent*.py``:
    :func:`family_cases` over :data:`RECURRENT`, and the encoder-decoder's
    frames (:func:`frames_case`)."""
    out = family_cases(group, cases, variants, grad_inputs)
    out["frames"] = frames_case(group)
    return out


def frames_case(group):
    """The encoder-decoder's batch on this rank against the one-card
    batch from the same generator: the agent's rows, bitwise, and the same
    on each of its model ranks."""
    cfg = family_cfg("encdec")
    n = group.n_agents
    one = data.batch_source(cfg, n, BATCH, SEQ, device="cpu")(
        torch.Generator().manual_seed(3), 0)
    mine = data.batch_source(cfg, n, BATCH, SEQ, device="cpu", group=group)(
        torch.Generator().manual_seed(3), 0)
    rows = {k: torch.equal(bits(v), bits(group.rows(one[k])))
            for k, v in mine.items()}
    full = group.all_gather([bits(mine[k]) for k in sorted(mine)],
                            axis="model")
    same = all(torch.equal(f[0], f[m]) for f in full
               for m in range(1, f.shape[0]))
    return dict(rows=rows, same_on_model_ranks=same,
                shapes={k: tuple(v.shape) for k, v in mine.items()})


# ---------------------------------------------------------------------------
# the other algorithms, remat and the qsgd codec on the model axis
# (tests/test_torch_tp_algos*.py)
# ---------------------------------------------------------------------------

def algo_setup(cfg, n, group, algo, *, plane=None, gossip="ring",
               wire="dense", comp="block_top_k", local=True,
               compress_fn=None, **over):
    """``algo`` built through ``api.build`` on the bundle of ``cfg`` (the
    tensor-parallel one under a grid with a model axis, with its leaf
    specs), ring Metropolis weights, ``comp`` at 5 %; under a model axis
    with ``local`` on the dense wire the shard-local compressor; else
    ``compress_fn`` (the one-card twin's)."""
    bundle = build_model(cfg, device="cpu", group=group)
    specs = None
    if group is not None and group.model_size > 1:
        specs = prepend_axis_specs(leaf_specs(bundle), group.axes[0])
    kw = {"levels": 7} if comp == "qsgd" else {}
    spec = api.ExperimentSpec(
        algo=algo, n_agents=n, topology="ring",
        topology_weights="metropolis", compressor=comp, frac=0.05,
        compressor_kwargs=kw, eta=ETA, tau=1.0, plane_dtype=plane,
        gossip_mode=gossip, wire=wire, **over)
    if (compress_fn is None and local and specs is not None
            and wire == "dense"):
        compress_fn = steps.make_shard_local_compress(
            api.resolve_compressor(spec))
    algorithm = api.build(spec, bundle.loss, device="cpu", group=group,
                          leaf_specs=specs, compress_fn=compress_fn)
    return steps.TrainSetup(cfg=cfg, bundle=bundle, algorithm=algorithm,
                            n_agents=n, porter_cfg=algorithm.config,
                            device=torch.device("cpu"))


def _twin_compress(specs, model, comp, wire, local):
    """The one-card twin's compression of a model-axis run: the per-shard
    compressor, the codec's per-shard round trip, or None (the whole-leaf
    compressor sees the same leaves on one card)."""
    if wire == "packed_bits":
        kw = {"levels": 7} if comp == "qsgd" else {"frac": 0.05}
        return steps.codec_on_one_card(WF.make_wire_format(comp, **kw),
                                       specs, model)
    if local:
        return steps.shard_local_on_one_card(steps.make_shard_local_compress(
            make_compressor(comp, frac=0.05)), specs, model)
    return None


def param_fields(state, specs):
    """The parameter-shaped trees of a (nested) state, by field name."""
    spec_def = tree_flatten(specs)[1]
    out = {}
    for name, field in zip(state._fields, state):
        if hasattr(field, "_fields"):
            out.update({f"{name}.{k}": v
                        for k, v in param_fields(field, specs).items()})
        elif (not isinstance(field, (int, torch.Tensor))
              and tree_flatten(field)[1] == spec_def):
            out[name] = field
    return out


def x_of(state):
    return state.base.x if hasattr(state, "base") else state.x


def algo_train(group, algo, *, plane=None, gossip="ring", wire="dense",
               comp="block_top_k", local=True, rounds=1, noise=False,
               arch_over=(), **over):
    """``rounds`` rounds of ``algo`` on the grid against the one-process
    twin (every agent in this process, the twin's compression): x's and
    every state field's largest difference, the metrics, the replicated
    leaves across the model ranks in every parameter-shaped buffer, the
    extra planes' shapes, the census.  ``noise``: one round with the
    one-card DP noise injected (dsgd's ``dp=True``); ``arch_over``: the
    smoke config's overrides."""
    cfg = smoke(**dict(arch_over))
    n, specs = group.n_agents, _specs(cfg)
    fn = _twin_compress(specs, group.model_size, comp, wire, local)
    one = algo_setup(cfg, n, None, algo, plane=plane,
                     gossip="dense" if wire != "dense" else gossip,
                     comp=comp, local=False, compress_fn=fn, **over)
    proc = algo_setup(cfg, n, group, algo, plane=plane, gossip=gossip,
                      wire=wire, comp=comp, local=local, **over)
    if noise:
        s1, m1 = _step_noise(one, cfg, n, None)
        group.census.clear()
        group.model_census.clear()
        s2, m2 = _step_noise(proc, cfg, n, group)
    else:
        s1, m1 = _run(one, cfg, n, None, rounds)
        group.census.clear()
        group.model_census.clear()
        s2, m2 = _run(proc, cfg, n, group, rounds)
    census = (dict(group.census), dict(group.model_census))
    forced = _forced_diff(one, proc, cfg, n, group, specs, algo,
                          over.get("clip_mode", "smooth"))
    full = runtime.gather_state(s2, group, specs)
    fields2 = param_fields(s2, specs)
    shapes_ok = all(
        tuple(a.shape) == tuple(b.shape) for tree in fields2.values()
        for a, b in zip(tree_leaves(tree), tree_leaves(x_of(s2))))
    mixer = proc.algorithm.mixer
    f1, ff = param_fields(s1, specs), param_fields(full, specs)
    # a planted fault: agent 1's replica left unchanged by the round(s)
    x0 = x_of(one.init_state(torch.Generator().manual_seed(0)))
    fault = tree_map(lambda a, b: torch.cat([a[:1], b[1:2], a[2:]]),
                     x_of(full), x0)
    return dict(
        x_diff=_max_abs(x_of(full), x_of(s1)), forced=forced,
        x_rel=_normwise(x_of(full), x_of(s1)),
        fault_x_rel=_normwise(fault, x_of(s1)),
        field_diff={k: _max_abs(ff[k], f1[k]) for k in f1},
        metrics_one=m1, metrics_proc=m2,
        replicated={k: _replicated_bitwise(group, t, specs)
                    for k, t in fields2.items()},
        shapes_ok=shapes_ok, fields=sorted(fields2),
        census=census, budget=dict(mixer.budget.per_leaf),
        n_leaves=len(tree_leaves(x_of(s2))),
        finite=all(bool(torch.isfinite(leaf).all())
                   for leaf in tree_leaves(x_of(s2))))


def _forced_diff(one, proc, cfg, n, group, specs, algo, mode):
    """The first round forced with the one-card gradient on both sides
    (clipped as ``algo`` clips it; Clip21 takes the raw gradient): the
    rank's x against its block of the one-card x, largest difference and
    bitwise."""
    src = data.batch_source(cfg, n, BATCH, SEQ, device="cpu")
    gb, gs = runtime.round_generators(0, 0, "cpu")
    s1 = one.init_state(torch.Generator().manual_seed(0))
    g, _ = vmap(grad_and_value(one.bundle.loss))(x_of(s1), src(gb, 0))
    if algo != "clip21":
        g = clipping.stacked_clip(g, 1.0, mode)
    zero = torch.zeros(n)
    s1, _ = one.step(s1, src(gb, 0), gs, grad_override=(zero, g))
    s2 = proc.init_state(torch.Generator().manual_seed(0))
    mine = data.batch_source(cfg, n, BATCH, SEQ, device="cpu", group=group)
    gb, gs = runtime.round_generators(0, 0, "cpu")
    s2, _ = proc.step(s2, mine(gb, 0), gs, grad_override=(
        zero[:1], _shard(g, specs, group, True)))
    want = _shard(x_of(s1), specs, group, True)
    return dict(x_diff=_max_abs(x_of(s2), want),
                bitwise=all(torch.equal(bits(a), bits(b)) for a, b in zip(
                    tree_leaves(x_of(s2)), tree_leaves(want))))


def _step_noise(setup, cfg, n, group):
    """One round with the one-card DP noise (all agents' whole leaves,
    seeded) injected."""
    state = setup.init_state(torch.Generator().manual_seed(0))
    source = data.batch_source(cfg, n, BATCH, SEQ, device="cpu", group=group)
    gb, gs = runtime.round_generators(0, 0, "cpu")
    z = _tree(cfg, n, torch.float32, 21)
    state, m = setup.step(state, source(gb, 0), gs, noise=z)
    return state, [{k: float(v) for k, v in m.items()}]


# label -> (algo, algo_train keywords)
ALGO_RUNS = {
    "dsgd": ("dsgd", {}),
    "dsgd-dp": ("dsgd", dict(dp=True, sigma_p=0.01, noise=True)),
    "choco": ("choco", {}),
    "choco-bf16": ("choco", dict(plane="bf16")),
    "subgrad": ("subgrad-comp", dict(clip_mode="piecewise")),
    "porter-adam": ("porter-adam", {}),
    "porter-adam-bf16": ("porter-adam", dict(plane="bf16")),
    "clip21": ("clip21", {}),
    "choco-whole": ("choco", dict(comp="top_k", local=False)),
    "choco-qsgd-whole": ("choco", dict(comp="qsgd", local=False)),
    "choco-randk-whole": ("choco", dict(comp="random_k", local=False)),
    "gc-qsgd-packed": ("porter-gc", dict(comp="qsgd", gossip="packed",
                                         wire="packed_bits")),
    "choco-qsgd-ring": ("choco", dict(comp="qsgd", gossip="ring",
                                      wire="packed_bits")),
    "csgp-qsgd-packed": ("dp-csgp", dict(comp="qsgd", gossip="packed",
                                         wire="packed_bits",
                                         sigma_p=0.01)),
}


def ef_gossip_case(group):
    """``ef_gossip`` (through ``FL.plane_apply``, as ``gossip_apply`` runs
    it) on this rank's per-shard planes against the one-card planes of all
    agents' whole leaves, f32 and bf16 EF buffers (the SR words from
    ``sr_draw``): bitwise, block for block."""
    from repro_torch.kernels import ops
    cfg = smoke()
    n, specs = group.n_agents, _specs(cfg)
    sharded = FL.sharded_spec(group, prepend_axis_specs(specs,
                                                        group.axes[0]))
    sh = lambda t: _shard(t, specs, group, True)   # noqa: E731
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        one = CommRound(make_compressor("top_k", frac=0.05), mixer=None,
                        backend="kernel",
                        plane_dtype=None if name == "f32" else dt)
        mine = dataclasses.replace(one, sharded=sharded)
        q, m, c, wc = (_tree(cfg, n, dt, s) for s in range(30, 34))
        y = _tree(cfg, n, torch.float32, 35)
        gen = lambda: torch.Generator().manual_seed(8)   # noqa: E731
        b1 = one.sr_draw(gen(), (q, m, y))
        b2 = mine.sr_draw(gen(), tuple(sh(t) for t in (q, m, y)))
        r1 = FL.plane_apply(lambda *p: ops.ef_gossip(*p, 0.3, 1.0,
                                                     sr_bits=b1),
                            (q, m, y, c, wc), 3)
        r2 = FL.plane_apply(lambda *p: ops.ef_gossip(*p, 0.3, 1.0,
                                                     sr_bits=b2),
                            tuple(sh(t) for t in (q, m, y, c, wc)), 3)
        out[name] = all(torch.equal(bits(a), bits(b)) for a, b in zip(
            tree_leaves([sh(t) for t in r1]), tree_leaves(list(r2))))
    return out


def clip_modes_case(group):
    """The cross-shard clip in every mode against the one-card clip, the
    factors and the clipped blocks; Clip21's residual norms and its
    estimate against the one-card ones; and each with a shard-local norm
    planted."""
    from repro_torch.core import clip21
    from repro_torch.kernels import ops
    cfg = smoke()
    n, specs = group.n_agents, _specs(cfg)
    sharded = FL.sharded_spec(group, prepend_axis_specs(specs,
                                                        group.axes[0]))
    bad = sharded._replace(group=_NoModelReduce(group))
    g = _tree(cfg, n, torch.float32, 40)
    mine = _shard(g, specs, group, True)
    out = {}
    for mode in ("smooth", "piecewise", "none"):
        want = _shard(clipping.stacked_clip(g, 1.0, mode), specs, group, True)
        spec1 = FL.flat_spec(g)
        if mode == "smooth":
            f1 = ops.clip_planes(FL.to_planes(g, spec1), n, 1.0)[2]
        else:
            f1 = clipping.clip_factor(torch.stack([
                clipping.tree_global_norm(tree_map(lambda a: a[i], g))
                for i in range(n)]), 1.0, mode)
        f1 = f1[group.index:group.index + 1]
        spec2 = FL.flat_spec(mine)
        _, f2 = clipping.cross_shard_clip(FL.to_planes(mine, spec2), spec2,
                                          1.0, sharded, mode)
        _, f3 = clipping.cross_shard_clip(FL.to_planes(mine, spec2), spec2,
                                          1.0, bad, mode)
        out[mode] = dict(
            block=_max_rel(clipping.stacked_clip(mine, 1.0, mode,
                                                 sharded=sharded), want),
            fault=_max_rel(clipping.stacked_clip(mine, 1.0, mode,
                                                 sharded=bad), want),
            factor=float(((f2 - f1).abs() / f1.abs()).max()),
            factor_fault=float(((f3 - f1).abs() / f1.abs()).max()),
            factor_bitwise=torch.equal(bits(f2), bits(f1)))
    # clip21: agent 0's residual inside tau (factor 1), agent 1's outside
    g_raw = _tree(cfg, n, torch.float32, 41)
    g_est = tree_map(lambda a: torch.cat([a[:1] * (1 + 1e-4),
                                          torch.zeros_like(a[1:])]), g_raw)
    delta = tree_map(torch.sub, g_raw, g_est)
    mine_d = _shard(delta, specs, group, True)
    n1 = clip21._agent_norms(delta)[group.index:group.index + 1]
    n2 = clip21._agent_norms(mine_d, sharded)
    n3 = clip21._agent_norms(mine_d, bad)
    est1 = _shard(clip21.clip21_update(g_est, g_raw, 1.0), specs, group,
                  True)
    mine_est, mine_raw = (_shard(t, specs, group, True)
                          for t in (g_est, g_raw))
    est2 = clip21.clip21_update(mine_est, mine_raw, 1.0, sharded)
    est3 = clip21.clip21_update(mine_est, mine_raw, 1.0, bad)
    out["clip21"] = dict(
        norms=float(((n2 - n1).abs() / n1).max()),
        norms_fault=float(((n3 - n1).abs() / n1).max()),
        factor_one=bool(n1[0] < 1.0),
        est=_max_rel(est2, est1), est_fault=_max_rel(est3, est1),
        est_bitwise=all(torch.equal(bits(a), bits(b))
                        for a, b in zip(tree_leaves(est2),
                                        tree_leaves(est1))))
    return out


def _count(group, fn):
    """``fn()`` with this rank's census cleared first: -> (its result, the
    agent-axis census, the model-axis census)."""
    group.census.clear()
    group.model_census.clear()
    out = fn()
    return out, dict(group.census), dict(group.model_census)


def remat_case(group):
    """``remat_policy`` "full" and "dots" around the tensor-parallel loss:
    the agent-vmapped gradient and the per-sample (DP) gradients bitwise
    the ones without remat, with the census of each beside the forward's;
    then a PORTER-GC and a PORTER-DP round through ``api.build`` with
    each policy against the round without it."""
    from repro_torch.core.remat import DOTS_REPLAYS, apply_remat
    cfg = smoke()
    n = group.n_agents
    tp = build_model(cfg, device="cpu", group=group)
    x = tree_map(lambda a: a[None], tp.init(torch.Generator().manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab, (n, 2, SEQ), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7))
    batch = {"tokens": group.rows(tokens)}

    def same(a, b):
        return all(torch.equal(bits(u), bits(v))
                   for u, v in zip(tree_leaves(a), tree_leaves(b))
                   if isinstance(u, torch.Tensor))

    def grads(loss):
        return vmap(grad_and_value(loss))(x, batch)

    def per_sample(loss):
        return clipping.per_sample_grads(loss, x, batch, "stacked")

    _, _, fwd = _count(group, lambda: vmap(tp.loss)(x, batch))
    out = {"forward": fwd}
    want = {"grad": _count(group, lambda: grads(tp.loss)),
            "per_sample": _count(group, lambda: per_sample(tp.loss))}
    for policy in ("full", "dots"):
        loss = apply_remat(tp.loss, policy)
        for kind, fn in (("grad", grads), ("per_sample", per_sample)):
            DOTS_REPLAYS.clear()
            got, agent, model = _count(group, lambda: fn(loss))
            ref, agent0, model0 = want[kind]
            out[f"{policy} {kind}"] = dict(
                bitwise=same(got, ref), agent_same=agent == agent0,
                rise={k: model.get(k, 0) - model0.get(k, 0)
                      for k in set(model) | set(model0)},
                replays=dict(DOTS_REPLAYS))
    # whole rounds through api.build
    for algo, over in (("porter-gc", {}), ("porter-dp", {"sigma_p": 0.01})):
        runs = {}
        for policy in (None, "full", "dots"):
            setup = algo_setup(cfg, n, group, algo, remat_policy=policy,
                               **over)
            runs[policy] = _count(group, lambda: _run(setup, cfg, n, group,
                                                      1))
        (s0, m0), agent0, model0 = runs[None]
        for policy in ("full", "dots"):
            (s1, m1), agent1, model1 = runs[policy]
            out[f"{policy} {algo} round"] = dict(
                bitwise=same(s1, s0), metrics_same=m1 == m0,
                agent_same=agent1 == agent0,
                rise={k: model1.get(k, 0) - model0.get(k, 0)
                      for k in set(model1) | set(model0)})
    return out


def _codec_rows(specs, n, model):
    """Rows of the global codec draw: every (agent, model shard) pair's
    windows of every leaf, a replicated leaf one shard."""
    total = 0
    for s in tree_leaves(specs):
        m = 1 if s.model_dim is None else model
        total += n * m * -(-(int(np.prod(s.shape)) // m) // WF.PACK_BLOCK)
    return total


def codec_draw_case(group, over=()):
    """The qsgd codec's per-shard draw: each process executor's ``c`` on
    this rank against the one-card twin's block (``steps.
    codec_on_one_card``) with the global draw injected and with the same
    generator, ``exchange_ps`` too; ``wc`` against the twin's dense
    ``W @ c``."""
    from repro_torch.core.gossip import make_dense_mixer, make_mixer
    cfg = smoke(**dict(over))
    n, specs = group.n_agents, _specs(cfg)
    sharded = FL.sharded_spec(group, prepend_axis_specs(specs,
                                                        group.axes[0]))
    codec = WF.make_wire_format("qsgd", levels=7)
    twin = steps.codec_on_one_card(codec, specs, group.model_size)
    top = api.resolve_topology(api.ExperimentSpec(n_agents=n))
    delta = _tree(cfg, n, torch.float32, 50)
    mine = _shard(delta, specs, group, True)
    noise = torch.rand((_codec_rows(specs, n, group.model_size),
                        WF.PACK_BLOCK),
                       generator=torch.Generator().manual_seed(9))
    gen = lambda: torch.Generator().manual_seed(10)   # noqa: E731
    out = {}
    for how, want in (("injected", twin(None, delta, noise=noise)),
                      ("drawn", twin(gen(), delta))):
        wc1 = _shard(make_dense_mixer(top.w)(want), specs, group, True)
        c1 = _shard(want, specs, group, True)
        for mode in ("ring", "packed"):
            mixer = make_mixer(top, mode, codec=codec, group=group,
                               sharded=sharded)
            kw = {"noise": noise} if how == "injected" else {}
            c2, wc2 = mixer.exchange(gen(), mine, 0, **kw)
            c3, _, cw, _ = mixer.exchange_ps(
                gen(), mine, torch.ones(1), 0, **kw)
            out[f"{how} {mode}"] = dict(
                c_bitwise=all(torch.equal(bits(a), bits(b)) for a, b in zip(
                    tree_leaves(c2), tree_leaves(c1))),
                ps_bitwise=all(torch.equal(bits(a), bits(b)) for a, b in zip(
                    tree_leaves(c3), tree_leaves(c1))),
                wc_diff=_max_abs(wc2, wc1), weight=float(cw[0]))
    # the reference's layout fault: every shard of an agent drawing the
    # agent's windows (the shards' blocks not kept)
    mixer = make_mixer(top, "packed", codec=codec, group=group)
    c4, _ = mixer.exchange(gen(), mine, 0)
    out["unsharded_draw_differs"] = not all(
        torch.equal(bits(a), bits(b)) for a, b in zip(
            tree_leaves(c4), tree_leaves(_shard(twin(gen(), delta), specs,
                                                group, True))))
    return out


def algo_cases(group, labels=tuple(ALGO_RUNS)):
    """The (data 2, model 2) cases of ``tests/test_torch_tp_algos.py``."""
    out = {label: algo_train(group, ALGO_RUNS[label][0],
                             **ALGO_RUNS[label][1]) for label in labels}
    out["ef_gossip"] = ef_gossip_case(group)
    out["clip"] = clip_modes_case(group)
    out["remat"] = remat_case(group)
    out["codec"] = codec_draw_case(group)
    return out


def algo_m4_cases(group):
    """The (data 2, model 4) cases of ``tests/test_torch_tp_algos_m4.py``:
    dsgd, choco and PORTER-GC on the qsgd packed codec on the smoke
    config widened to 4 kv heads, and the codec's per-shard draw."""
    over = (("n_kv_heads", 4),)
    out = {label: algo_train(group, ALGO_RUNS[label][0], arch_over=over,
                             **ALGO_RUNS[label][1])
           for label in ("dsgd", "choco", "gc-qsgd-packed")}
    out["codec"] = codec_draw_case(group, over)
    return out

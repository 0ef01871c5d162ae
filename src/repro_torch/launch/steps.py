"""The LM train step (``src/repro/launch/steps.py``'s ``TrainSetup`` and
``build_train_step``), all agents on one card or one agent a process.

``build_train_step(cfg, n_agents, ...)`` builds the model bundle of ``cfg``
and, through :func:`repro_torch.api.build`, the registered algorithm over
``n_agents`` agents with ``bundle.loss`` as each agent's loss.  It keeps the
reference's knobs and their defaults: PORTER-GC (``variant``), the
``block_top_k`` compressor at 5 %, a ring with Metropolis weights, tau 1,
eta 1e-3, f32 EF planes unless ``plane_dtype`` says bf16, and
``remat_policy`` around the loss.  ``launch.train.main`` builds through it.

    setup = build_train_step(cfg, n_agents=4, compressor_name="top_k",
                             eta=3e-2)
    state = setup.init_state(torch.Generator("cuda").manual_seed(0))
    state, metrics = setup.step(state, batch, gen)

With ``group=`` (an :class:`repro_torch.launch.mesh.AgentGroup`, the
reference's agent axes of its mesh) every agent is a process: the rank's
state and batch are its agent's row and the gossip executors ship its
buffers across the group.  On a ``(data, model)`` grid (``group.model_size
= M > 1``) each agent's replica is split over its M ranks as the
reference's PartitionSpecs say, for every family (the decoders: dense GQA
and MLA, MoE ffn- and expert-parallel, the VLM; rwkv6, the Mamba2 hybrid
and the encoder-decoder; tied or untied, vocab-parallel or d_model-sharded
embeddings) and the variants 'gc', 'dp', 'beer' and 'csgp' (the
reference's four), with any ``remat_policy`` and any wire codec (a qsgd
codec packs each shard with its block of one global draw): the bundle is
the tensor-parallel one
(:func:`repro_torch.models.build_model` ``group=``), the leaf specs go to
``api.build`` (per-shard planes, the cross-shard clip in every mode,
push-sum weights replicated on an agent's ranks), and ``local_compress``
picks the reference's shard-local compressor
(:func:`make_shard_local_compress`) over the whole-leaf one.  The other
decentralized algorithms (dsgd, choco, subgrad-comp, porter-adam,
clip21) run there through ``api.build(spec, bundle.loss, group=,
leaf_specs=)``.  :func:`shard_local_on_one_card` and
:func:`codec_on_one_card` compute on one card what a model axis's
per-shard compressor and codec give.  The fleet axis and the server
algorithms run across processes through ``api.build(..., group=)`` (on
an agent grid; beside a model axis they are ROADMAP queue 1 item 20).
Item 12(c) keeps an SR draw that costs a rank only its own block and the
NCCL path; the prefill and serve steps and the launch tooling are item
14.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import api
from ..core.agents import model_shard
from ..core.comm_round import compress_stacked
from ..core.compression import Compressor
from ..core.porter import PorterConfig
from ..models import ModelBundle, ModelConfig, build_model
from ..nn.module import leaf_specs, prepend_axis_specs
from ..tree import tree_flatten, tree_leaves

__all__ = ["TrainSetup", "build_train_step", "make_shard_local_compress",
           "shard_local_on_one_card", "codec_on_one_card"]


def make_shard_local_compress(comp: Compressor):
    """Shard-local compression (``src/repro/launch/steps.py:38-70``): each
    rank compresses its own shard of every leaf, per agent row, so the
    selection never crosses a shard boundary (per-shard top-k is block
    top-k with shard-sized blocks, still a rho-compressor).  Only
    deterministic compressors, as in the reference: a randomized one would
    need per-shard draws."""
    if not comp.deterministic:
        raise ValueError("shard-local compression needs a deterministic "
                         "compressor (top_k / block_top_k)")

    def compress(gen, tree):
        del gen      # deterministic
        return compress_stacked(comp, None, tree)

    return compress


def shard_local_on_one_card(compress, specs, model_size: int):
    """What a shard-local ``compress(gen, tree)`` gives on a grid with a
    model axis of ``model_size``, computed with every agent on one card:
    each leaf of the all-agents tree cut into its model shards (``specs``:
    one replica's :class:`repro_torch.nn.module.Spec` tree), ``compress``
    applied to each shard's tree, the shards joined (a replicated leaf
    compressed once).  Deterministic compressors only."""
    dims = [s.model_dim for s in tree_leaves(specs)]

    def fn(gen, tree):
        leaves, treedef = tree_flatten(tree)
        shards = [tree_leaves(compress(gen, treedef.unflatten([
            model_shard(leaf, None if d is None else d + 1, m, model_size)
            for leaf, d in zip(leaves, dims)]))) for m in range(model_size)]
        return treedef.unflatten([
            shards[0][i] if d is None else
            torch.cat([s[i] for s in shards], dim=d + 1)
            for i, d in enumerate(dims)])

    return fn


def codec_on_one_card(codec, specs, model_size: int):
    """What a wire codec's process executor packs on a grid with a model
    axis of ``model_size``, computed with every agent on one card: each
    leaf cut into its model shards (``specs``: one replica's
    :class:`repro_torch.nn.module.Spec` tree; a replicated leaf one
    shard), every shard's windows packed and unpacked on their own.  A
    randomized codec (qsgd) draws one global ``(rows, PACK_BLOCK)``
    uniform plane from ``gen`` -- leaf by leaf, every agent's windows of
    its every shard, agent-major -- and packs each shard with its block,
    as each rank keeps its block of the same draw
    (``core.gossip._pack_rank``).  Returns ``compress(gen, tree, noise=
    None)``; ``noise`` injects that global plane."""
    from ..core.gossip import draw_blocks, draw_rows
    from ..core.wire_formats import PACK_BLOCK, to_windows
    dims = [s.model_dim for s in tree_leaves(specs)]

    def fn(gen, tree, noise=None):
        leaves, treedef = tree_flatten(tree)
        n = leaves[0].shape[0]
        cut = [[leaf] if d is None else
               [model_shard(leaf, d + 1, m, model_size)
                for m in range(model_size)]
               for leaf, d in zip(leaves, dims)]
        wins = [[to_windows(p.reshape(n, -1).to(torch.float32))
                 for p in parts] for parts in cut]
        nbs, shards = [w[0].shape[1] for w in wins], [len(w) for w in wins]
        if noise is None and not codec.deterministic:
            noise = torch.rand((draw_rows(n, nbs, shards), PACK_BLOCK),
                               generator=gen, device=leaves[0].device)
        blocks = ([None] * len(leaves) if noise is None
                  else draw_blocks(noise, n, nbs, shards))
        out = []
        for leaf, d, parts, w, block in zip(leaves, dims, cut, wins, blocks):
            cs = []
            for m, (part, rows) in enumerate(zip(parts, w)):
                z = (None if block is None
                     else block[:, m].reshape(-1, PACK_BLOCK))
                c = codec.unpack(*codec.pack(rows.reshape(-1, PACK_BLOCK),
                                             z))
                cs.append(c.reshape(n, -1)[:, :part[0].numel()]
                          .reshape(part.shape).to(leaf.dtype))
            out.append(cs[0] if d is None else torch.cat(cs, dim=d + 1))
        return treedef.unflatten(out)

    return fn


@dataclasses.dataclass
class TrainSetup:
    """What :func:`build_train_step` built."""
    cfg: ModelConfig
    bundle: ModelBundle
    algorithm: Any               # the built repro_torch.api Algorithm
    n_agents: int
    porter_cfg: Optional[PorterConfig]
    device: torch.device

    @property
    def step(self):
        """``(state, batch, gen) -> (state, metrics)``."""
        return self.algorithm.step

    def init_state(self, gen: torch.Generator):
        """The algorithm's state from parameters drawn from ``gen`` (on the
        generator's device), every agent starting at the same replica."""
        return self.algorithm.init(self.bundle.init(gen),
                                   n_agents=self.n_agents)


def build_train_step(
    cfg: ModelConfig,
    n_agents: int,
    variant: str = "gc",
    compressor_name: str = "block_top_k",
    frac: float = 0.05,
    topology_kind: str = "ring",
    topology_schedule: Optional[str] = None,
    tau: float = 1.0,
    sigma_p: float = 0.0,
    eta: float = 1e-3,
    plane_dtype=None,
    remat_policy: Optional[str] = None,
    comm_backend: str = "auto",
    fleet: bool = False,
    gossip_mode: str = "dense",
    wire: str = "dense",
    device=None,
    group=None,
    local_compress: bool = False,
) -> TrainSetup:
    """The train step of ``cfg`` over ``n_agents`` agents on ``device``
    (cuda unless given; the group's device under ``group``).

    variant: a key of the reference's ``VARIANT_TO_ALGO`` ('gc', 'dp',
    'beer', 'csgp'), or a registered algorithm's name.  ``comm_backend``
    'auto' runs the ef kernels on the card; ``plane_dtype`` 'bf16' keeps
    the six EF planes in bf16 beside f32 master parameters;
    ``remat_policy`` None, 'full' or 'dots' (:mod:`repro_torch.core.remat`);
    ``fleet`` mixes all agents on one axis (:mod:`repro_torch.core.fleet`);
    ``gossip_mode`` 'dense', 'ring' or 'packed' picks the gossip executor
    (:func:`repro_torch.core.gossip.make_mixer`), as the reference's knob;
    ``wire`` 'dense' or 'packed_bits' (the codec executors under 'ring' or
    'packed'), the reference's knob too.
    ``group``: one agent a rank (``n_agents`` ranks), or ``M`` ranks an
    agent on a grid with a model axis; ``init_state`` then returns this
    rank's row (of its shard), and a batch source built with the same
    group (``data.batch_source(..., group=)``) feeds its step, every model
    rank of an agent the agent's batch.  ``local_compress`` (the
    reference's knob, on a model axis and the dense wire): each rank
    compresses its shard; else the compressor sees each whole leaf (one
    all-gather over ``'model'`` a compression).  Under
    ``wire="packed_bits"`` the codec packs each shard's windows either way.
    """
    if device is None:
        device = "cuda" if group is None else group.device
    device = torch.device(device)
    bundle = build_model(cfg, device=device, group=group)
    specs = None
    if group is not None and group.model_size > 1:
        axes = group.axes if len(group.axes) > 1 else group.axes[0]
        specs = prepend_axis_specs(leaf_specs(bundle), axes)
    algo_name = api.VARIANT_TO_ALGO.get(variant, variant)
    spec = api.ExperimentSpec(
        algo=algo_name, n_agents=n_agents, topology=topology_kind,
        topology_weights="metropolis", topology_schedule=topology_schedule,
        compressor=compressor_name, frac=frac, comm_backend=comm_backend,
        eta=eta, tau=tau, sigma_p=sigma_p, plane_dtype=plane_dtype,
        remat_policy=remat_policy, fleet=fleet, gossip_mode=gossip_mode,
        wire=wire)
    compress_fn = None
    if local_compress and specs is not None:
        compress_fn = make_shard_local_compress(api.resolve_compressor(spec))
    algo = api.build(spec, bundle.loss, device=device, group=group,
                     leaf_specs=specs, compress_fn=compress_fn)
    return TrainSetup(cfg=cfg, bundle=bundle, algorithm=algo,
                      n_agents=n_agents, porter_cfg=algo.config,
                      device=device)

"""repro_torch.api -- the facade: ExperimentSpec -> ready-to-train Algorithm.

The PyTorch counterpart of ``src/repro/api.py`` for this slice:

    from repro_torch.api import ExperimentSpec, build

    spec = ExperimentSpec(algo="porter-gc", n_agents=10,
                          topology="erdos_renyi", topology_p=0.8,
                          compressor="top_k", frac=0.05, eta=0.05, tau=1.0)
    algo = build(spec, loss_fn)               # device defaults to cuda
    state = algo.init(params0)
    state, metrics = algo.step(state, batch, gen)

``build`` resolves the topology and mixing matrix, the compressor, the
comm-round engine and the consensus stepsize

    gamma = gamma_scale * (1 - alpha) * rho

with ``alpha`` the topology's mixing rate and ``rho`` the compressor's
contraction factor.  A ``topology_schedule`` string (the reference's
grammar, :func:`resolve_schedule`) swaps the static graph for a
time-varying :class:`TopologySchedule`: the mixer picks ``W_t`` by the
state's step, and ``alpha`` is the schedule's per-round rate.  Directed
(column-stochastic) schedules are for the push-sum algorithm (dp-csgp)
only.  ``build`` targets ``torch.device("cuda")`` unless the caller passes
``device=``; nothing here probes for a card and moves to the CPU.

Fleet mode (``ExperimentSpec(fleet=True)``): the agent axis is a
simulated fleet of n = 1k-100k agents on one card, mixed by
:func:`repro_torch.core.fleet.make_fleet_mixer`: the dense mixer at
``n <= FLEET_DENSE_GATE`` (bitwise the per-device engine) and the sparse
COO slots above it, where the topology and schedule builders also switch
to the sparse fleet generators (:func:`resolve_fleet_topology`,
:func:`resolve_fleet_schedule`).  Under ``group=`` the fleet axis is
sharded over the group's P ranks, k = n / P agents a rank.

Registered here, all eleven of the reference's algorithms: ``porter-gc``,
``porter-dp``, ``beer``, ``porter-adam``, the paper's baselines ``dsgd``,
``choco``, ``dp-sgd`` and ``soteriafl``, and ``dp-csgp``, ``clip21`` and
``subgrad-comp``.  ``plane_dtype="bf16"`` keeps the EF buffers in bf16 (the
master params stay f32).  ``gossip_mode`` "ring" (a ring band, or a
schedule of them) or "packed" (top-k pairs) picks the reference's other
executors, every agent on one card; with ``wire="packed_bits"`` either
gossips bit-packed buffers (:func:`resolve_wire_format`).  ``build(...,
group=)`` puts each agent in a process of a
:class:`repro_torch.launch.mesh.AgentGroup` (the reference's ``mesh=``):
the executors ship buffers across the group's ranks.  On a grid with a
model axis (``group.model_size > 1``) ``build(..., group=, leaf_specs=)``
takes the leaves' specs (the agent axes first, as the reference's
``leaf_specs=``): the engine runs on per-shard planes (dsgd, which has no
engine, takes the layout itself), the clip across shards in every mode
(Clip21's residual norm too) and the metrics over the whole replica; every
decentralized algorithm of the registry runs there, with any
``remat_policy`` and any wire codec (a qsgd codec draws each shard's
block of one global draw: :func:`repro_torch.core.gossip.make_mixer`).
The server algorithms (dp-sgd, soteriafl) run with one client a rank (the
server's mean or pooled batch one all-gather, the server's state the same
on every rank) and the fleet with n / P agents a rank; beside a model axis
both are ROADMAP queue 1 item 20.  The spec keeps the reference's field
names.  ``remat_policy`` (None, ``"full"``, ``"dots"``) wraps the loss once
in ``build`` for every algorithm (:mod:`repro_torch.core.remat`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Optional, Union

import torch

from .core import baselines as BL
from .core import mixing as MX
from .core.beer import beer_config
from .core.clip21 import Clip21State, clip21_init, clip21_step
from .core.comm_round import CommRound
from .kernels import flatten as FL
from .core import wire_formats
from .core.compression import Compressor, make_compressor
from .core.fleet import (FLEET_DENSE_GATE, FleetSchedule, FleetTopology,
                         fleet_er_schedule, fleet_rotating_schedule,
                         fleet_topology, make_fleet_mixer)
from .core.gossip import make_mixer
from .core.mixing import Topology, TopologySchedule, make_topology
from .core.porter import PorterConfig, PorterState, porter_init, porter_step
from .core.porter_adam import (PorterAdamState, porter_adam_init,
                               porter_adam_step)
from .core.push_sum import DpCsgpState, dp_csgp_init, dp_csgp_step
from .core.remat import apply_remat
from .core.registry import (Algorithm, AlgorithmInfo, algorithm_info,
                            get_factory, list_algorithms, register_algorithm)
from .core.subgrad import SubgradState, subgrad_init, subgrad_step
from .tree import tree_leaves, tree_map

__all__ = ["ExperimentSpec", "build", "build_engine", "resolve_topology",
           "resolve_schedule", "resolve_fleet_topology",
           "resolve_fleet_schedule", "resolve_compressor", "resolve_gamma",
           "resolve_plane_dtype", "resolve_wire_format",
           "VARIANT_TO_ALGO", "Algorithm", "AlgorithmInfo", "algorithm_info",
           "list_algorithms"]

# the launchers' --variant spelling -> the registry name (the reference's
# mapping)
VARIANT_TO_ALGO = {"gc": "porter-gc", "dp": "porter-dp", "beer": "beer",
                   "csgp": "dp-csgp"}

# compressors whose knob is a kept-fraction (rho = frac)
_FRAC_COMPRESSORS = ("top_k", "block_top_k", "random_k")

# the algorithms that de-bias column-stochastic (directed) mixing; build
# refuses a directed schedule for every other one
_PUSH_SUM_ALGOS = frozenset({"dp-csgp"})

_PLANE_DTYPES = {"f32": torch.float32, "float32": torch.float32,
                 "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Declarative description of one decentralized-training experiment,
    with the reference's field names and defaults.

    ``gamma=None`` derives gamma_scale * (1 - alpha) * rho.  ``tau=None``
    disables clipping for porter-gc (which is then BEER); the DP
    algorithms reject it.  ``topology_schedule``: None (the static graph)
    or a schedule string, :func:`resolve_schedule`.  ``comm_backend`` is
    'auto' | 'kernel' | 'ref'.
    """

    algo: str = "porter-gc"
    n_agents: int = 10
    fleet: bool = False
    topology: str = "ring"
    topology_weights: str = "metropolis"
    topology_p: float = 0.8
    topology_seed: int = 0
    topology_schedule: Optional[str] = None
    compressor: str = "top_k"
    frac: float = 0.05
    compressor_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    gossip_mode: str = "dense"
    wire: str = "dense"
    overlap: bool = False
    comm_backend: str = "auto"
    eta: float = 0.05
    gamma: Optional[float] = None
    gamma_scale: float = 0.5
    tau: Optional[float] = 1.0
    clip_mode: str = "smooth"
    sigma_p: float = 0.0
    dp: bool = False                 # per-sample clip + noise oracle (dsgd)
    b1: float = 0.9                  # porter-adam moments
    b2: float = 0.999
    adam_eps: float = 1e-8
    alpha_shift: float = 0.5         # soteriafl shift stepsize
    buffer_dtype: Any = torch.float32
    plane_dtype: Any = None
    remat_policy: Optional[str] = None

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Resolved:
    """What :func:`build` constructed from a spec (the factory context)."""

    info: AlgorithmInfo
    # None for server/client algorithms; a FleetTopology above the gate
    topology: Optional[Union[Topology, FleetTopology]]
    compressor: Optional[Compressor]  # None for uncompressed ones
    mixer: Any
    engine: Optional[CommRound]
    gamma: Optional[float]
    device: torch.device
    schedule: Optional[Union[TopologySchedule, FleetSchedule]] = None
    group: Any = None
    # the per-shard layout on a grid with a model axis, else None
    sharded: Optional[FL.ShardedFlatSpec] = None


def resolve_topology(spec: ExperimentSpec) -> Topology:
    return make_topology(spec.topology, spec.n_agents,
                         weights=spec.topology_weights, p=spec.topology_p,
                         seed=spec.topology_seed)


def _parse_schedule_kv(rest: str) -> Mapping[str, str]:
    kv = {}
    for item in filter(None, (s.strip() for s in rest.split(","))):
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(
                f"bad schedule argument {item!r}: expected key=value "
                "(e.g. 'dropout:rate=0.2,period=8')")
        kv[k.strip()] = v.strip()
    return kv


def resolve_schedule(spec: ExperimentSpec,
                     topology: Optional[Topology] = None
                     ) -> Optional[TopologySchedule]:
    """``spec.topology_schedule`` -> a :class:`TopologySchedule` or None.

    The reference's grammar (``src/repro/api.py``)::

        "static"                              period 1 around the topology
        "rotate:ring+star+complete"           one graph kind a round
        "rotate:ring/metropolis+ring/lazy"    per-round weight schemes
        "rotate:ring+star,weights=lazy"       bare kinds + key=value knobs
        "erdos_renyi:period=8,p=0.6"          a fresh connected ER a round
        "dropout:rate=0.2,period=8"           agent churn
        "straggler:rate=0.3,period=8"         per-link deadline misses
        "directed:ring_skips,skip=2"          column-stochastic (push-sum):
        "directed:digraph,p=0.5,period=8"     ring with chords, random
        "directed:one_way,rate=0.2,period=8"  digraph, one-way link loss

    Unset knobs default to the spec's topology fields (weights, p, seed,
    and the base graph of the churn kinds); ``topology`` stands in for the
    spec's graph in ``static``.
    """
    if spec.topology_schedule is None:
        return None
    text = spec.topology_schedule
    kind, _, rest = text.partition(":")
    kind = kind.strip()
    if kind == "static":
        if rest.strip():
            raise ValueError(f"'static' schedule takes no arguments; got "
                             f"{text!r}")
        top = resolve_topology(spec) if topology is None else topology
        return MX.static_schedule(top)
    if kind == "directed":
        return _resolve_directed_schedule(spec, text, rest)
    allowed = {"rotate": {"kinds", "weights", "p", "seed"},
               "erdos_renyi": {"p", "period", "weights", "seed"},
               "dropout": {"rate", "period", "base", "weights", "p", "seed"},
               "straggler": {"rate", "period", "base", "weights", "p",
                             "seed"}}
    if kind not in allowed:
        raise ValueError(
            f"unknown topology schedule kind {kind!r} in {text!r}; have "
            "static, rotate, erdos_renyi, dropout, straggler, directed")
    first, _, more = rest.partition(",")
    if kind == "rotate" and rest and "=" not in first:
        # the kinds list may lead bare: 'rotate:ring+star,weights=lazy'
        kv = {"kinds": first.strip(), **_parse_schedule_kv(more)}
    else:
        kv = dict(_parse_schedule_kv(rest))
    # typo'd keys go before a generator runs (the churn kinds draw up to
    # 1000 windows)
    unknown = set(kv) - allowed[kind]
    if unknown:
        raise ValueError(f"unknown {kind!r} schedule keys {sorted(unknown)} "
                         f"in {text!r}; allowed: {sorted(allowed[kind])}")
    if kind == "rotate":
        kinds = [k for k in kv.pop("kinds", "").split("+") if k]
        if not kinds:
            raise ValueError("rotate schedule needs '+'-separated graph "
                             "kinds, e.g. 'rotate:ring+star+complete'")
        return MX.rotating_schedule(
            kinds, spec.n_agents,
            weights=kv.pop("weights", spec.topology_weights),
            p=float(kv.pop("p", spec.topology_p)),
            seed=int(kv.pop("seed", spec.topology_seed)))
    if kind == "erdos_renyi":
        return MX.erdos_renyi_schedule(
            spec.n_agents, p=float(kv.pop("p", spec.topology_p)),
            period=int(kv.pop("period", 8)),
            weights=kv.pop("weights", spec.topology_weights),
            seed=int(kv.pop("seed", spec.topology_seed)))
    gen = (MX.dropout_schedule if kind == "dropout"
           else MX.straggler_schedule)
    return gen(
        spec.n_agents, rate=float(kv.pop("rate", 0.2)),
        period=int(kv.pop("period", 8)),
        base=kv.pop("base", spec.topology),
        weights=kv.pop("weights", spec.topology_weights),
        p=float(kv.pop("p", spec.topology_p)),
        seed=int(kv.pop("seed", spec.topology_seed)))


def _resolve_directed_schedule(spec: ExperimentSpec, text: str,
                               rest: str) -> TopologySchedule:
    """'directed:<subkind>,key=value,...' -> a column-stochastic schedule:
    ``ring_skips`` {skip}, ``digraph`` {p, period, seed}, ``one_way``
    {rate, period, skip, seed}."""
    first, _, more = rest.partition(",")
    sub = first.strip()
    if not sub or "=" in sub:
        raise ValueError(
            f"directed schedule needs a leading subkind in {text!r}, e.g. "
            "'directed:ring_skips,skip=2'; have ring_skips, digraph, "
            "one_way")
    allowed = {"ring_skips": {"skip"},
               "digraph": {"p", "period", "seed"},
               "one_way": {"rate", "period", "skip", "seed"}}
    if sub not in allowed:
        raise ValueError(
            f"unknown directed schedule subkind {sub!r} in {text!r}; have "
            f"{sorted(allowed)}")
    kv = dict(_parse_schedule_kv(more))
    unknown = set(kv) - allowed[sub]
    if unknown:
        raise ValueError(f"unknown directed:{sub} schedule keys "
                         f"{sorted(unknown)} in {text!r}; allowed: "
                         f"{sorted(allowed[sub])}")
    if sub == "ring_skips":
        return MX.directed_ring_schedule(spec.n_agents,
                                         skip=int(kv.pop("skip", 0)))
    if sub == "digraph":
        return MX.random_digraph_schedule(
            spec.n_agents, p=float(kv.pop("p", spec.topology_p)),
            period=int(kv.pop("period", 8)),
            seed=int(kv.pop("seed", spec.topology_seed)))
    return MX.directed_churn_schedule(
        spec.n_agents, rate=float(kv.pop("rate", 0.2)),
        period=int(kv.pop("period", 8)), skip=int(kv.pop("skip", 2)),
        seed=int(kv.pop("seed", spec.topology_seed)))


def _check_fleet_spec(spec: ExperimentSpec, algo: Optional[str] = None):
    """Reject spec combinations the fleet executor cannot honour."""
    if spec.gossip_mode != "dense":
        raise ValueError(
            f"fleet mode applies mixing as one vectorized dense/COO sweep "
            f"over the whole fleet axis; gossip_mode={spec.gossip_mode!r} "
            "is a per-device wire executor -- use gossip_mode='dense'")
    if spec.wire != "dense":
        raise ValueError(
            f"fleet mode ships no per-link packed buffers (the simulated "
            f"fleet axis is device-local); wire={spec.wire!r} -- use "
            "wire='dense'")
    if algo in _PUSH_SUM_ALGOS and spec.n_agents > FLEET_DENSE_GATE:
        raise ValueError(
            f"{algo} initializes its push-sum mirrors from the dense "
            f"round-0 mixing table; fleet mode supports it only at "
            f"n_agents <= {FLEET_DENSE_GATE} (got {spec.n_agents})")


def resolve_fleet_topology(spec: ExperimentSpec
                           ) -> Union[Topology, FleetTopology]:
    """Fleet topology: the dense resolution at ``n <= FLEET_DENSE_GATE``
    (bitwise the per-device engine), the sparse COO builders of
    :mod:`repro_torch.core.fleet` above it (``make_topology``'s O(n^2)
    weight loops and dense eigensolves do not survive n = 100k)."""
    if spec.n_agents <= FLEET_DENSE_GATE:
        return resolve_topology(spec)
    return fleet_topology(spec.topology, spec.n_agents,
                          weights=spec.topology_weights, p=spec.topology_p,
                          seed=spec.topology_seed)


def resolve_fleet_schedule(spec: ExperimentSpec, topology=None
                           ) -> Optional[Union[TopologySchedule,
                                               FleetSchedule]]:
    """Fleet analogue of :func:`resolve_schedule`: the dense resolution
    below the gate, the sparse generators ('rotate:...', 'erdos_renyi:...')
    above it.  Directed (column-stochastic) schedules never take the fleet
    path."""
    if spec.topology_schedule is None:
        return None
    if spec.n_agents <= FLEET_DENSE_GATE:
        top = topology if isinstance(topology, Topology) else None
        sched = resolve_schedule(spec, top)
        if sched is not None and sched.is_directed:
            raise ValueError(
                "fleet mode mixes with doubly-stochastic tables only; "
                f"{spec.topology_schedule!r} is column-stochastic (push-sum "
                "runs per-device, fleet=False)")
        return sched
    text = spec.topology_schedule
    kind, _, rest = text.partition(":")
    kind = kind.strip()
    if kind == "rotate":
        first, _, more = rest.partition(",")
        if "=" not in first:
            kv = {"kinds": first.strip(), **_parse_schedule_kv(more)}
        else:
            kv = dict(_parse_schedule_kv(rest))
        kinds = [k for k in kv.pop("kinds", "").split("+") if k]
        if not kinds:
            raise ValueError("rotate schedule needs '+'-separated graph "
                             "kinds, e.g. 'rotate:ring+exponential'")
        sched = fleet_rotating_schedule(
            kinds, spec.n_agents,
            weights=kv.pop("weights", spec.topology_weights),
            seed=int(kv.pop("seed", spec.topology_seed)))
    elif kind == "erdos_renyi":
        kv = dict(_parse_schedule_kv(rest))
        degree = kv.pop("degree", None)
        sched = fleet_er_schedule(
            spec.n_agents, period=int(kv.pop("period", 4)),
            degree=None if degree is None else int(degree),
            weights=kv.pop("weights", spec.topology_weights),
            seed=int(kv.pop("seed", spec.topology_seed)))
    else:
        raise ValueError(
            f"fleet mode at n_agents={spec.n_agents} > {FLEET_DENSE_GATE} "
            f"supports the sparse generators 'rotate:...' and "
            f"'erdos_renyi:...'; got {text!r}")
    if kv:
        raise ValueError(f"unknown fleet {kind!r} schedule keys "
                         f"{sorted(kv)} in {text!r}")
    return sched


def resolve_compressor(spec: ExperimentSpec) -> Compressor:
    kwargs = dict(spec.compressor_kwargs)
    if spec.compressor in _FRAC_COMPRESSORS:
        kwargs.setdefault("frac", spec.frac)
    return make_compressor(spec.compressor, **kwargs)


def resolve_plane_dtype(spec_or_name) -> Optional[torch.dtype]:
    """``spec.plane_dtype`` -> a torch dtype or None (f32 planes)."""
    val = (spec_or_name.plane_dtype
           if isinstance(spec_or_name, ExperimentSpec) else spec_or_name)
    if val is None:
        return None
    if isinstance(val, str):
        if val not in _PLANE_DTYPES:
            raise ValueError(f"unknown plane_dtype {val!r}; have "
                             f"{sorted(_PLANE_DTYPES)}")
        val = _PLANE_DTYPES[val]
    if val not in (torch.float32, torch.bfloat16):
        raise ValueError(f"plane_dtype must be f32 or bf16, got {val}")
    return val


def resolve_gamma(spec: ExperimentSpec,
                  topology: Union[Topology, FleetTopology],
                  compressor: Compressor,
                  schedule: Optional[Union[TopologySchedule,
                                           FleetSchedule]] = None) -> float:
    """The paper's consensus stepsize: gamma_scale * (1 - alpha) * rho,
    with a schedule's per-round rate as alpha when there is one (a fleet
    topology's or schedule's alpha above the gate).  A derived
    0 (``low_rank`` and ``sign`` report rho = 0) is refused: pass
    ``gamma=``."""
    if spec.gamma is not None:
        return spec.gamma
    alpha = topology.alpha if schedule is None else schedule.alpha
    gamma = spec.gamma_scale * (1.0 - alpha) * compressor.rho
    if gamma <= 0.0:
        raise ValueError(
            f"derived gamma is 0 (alpha={alpha:.4g}, "
            f"rho={compressor.rho:.4g} for {compressor.name}); pass an "
            "explicit gamma= in the ExperimentSpec")
    return gamma


def resolve_wire_format(spec: ExperimentSpec):
    """``spec.wire`` -> a :class:`wire_formats.WireFormat` or None.

    'packed_bits' registers the compressor family's bit-packed layout
    (top_k / block_top_k -> ``topk_bits`` at ``spec.frac``; qsgd ->
    ``qsgd_bits`` at ``compressor_kwargs["levels"]``, 16 by default).  The
    codec runs the CUDA kernels unless ``comm_backend='ref'``, which runs
    their plain versions on any device.
    """
    if spec.wire == "dense":
        return None
    if spec.wire != "packed_bits":
        raise ValueError(f"unknown wire format {spec.wire!r}; have "
                         f"{wire_formats.WIRE_MODES}")
    if spec.gossip_mode not in ("ring", "packed"):
        raise ValueError(
            "wire='packed_bits' needs gossip_mode 'ring' or 'packed' "
            f"(got {spec.gossip_mode!r}); dense gossip ships the dense "
            "emulation by definition")
    use_kernel = spec.comm_backend != "ref"
    if spec.compressor == "qsgd":
        levels = int(spec.compressor_kwargs.get("levels", 16))
        return wire_formats.make_wire_format("qsgd", levels=levels,
                                             use_kernel=use_kernel)
    return wire_formats.make_wire_format(spec.compressor, frac=spec.frac,
                                         use_kernel=use_kernel)


def _check_group(spec: ExperimentSpec, group) -> None:
    """Refuse what the agents-as-processes executors do not run: a server
    algorithm or a fleet beside a model axis, a fleet whose n does not
    divide over the ranks, any other count than one agent (or client) a
    rank."""
    if group is None:
        return
    server = not algorithm_info(spec.algo).decentralized
    if (server or spec.fleet) and getattr(group, "model_size", 1) > 1:
        what = (f"{spec.algo}, a server algorithm," if server
                else "the fleet axis")
        raise ValueError(
            f"{what} does not run beside a model axis (model_size "
            f"{group.model_size}): ROADMAP queue 1 item 20 -- build it on a "
            "grid without one")
    if spec.fleet and not server:
        if spec.n_agents % group.n_agents:
            raise ValueError(
                f"a fleet of spec.n_agents={spec.n_agents} does not divide "
                f"over the group's {group.n_agents} ranks (k = n / ranks "
                "agents a rank)")
        return
    if spec.n_agents != group.n_agents:
        raise ValueError(f"spec.n_agents={spec.n_agents} but the group has "
                         f"{group.n_agents} ranks: one agent a rank")


def _sharded(group, leaf_specs) -> Optional[FL.ShardedFlatSpec]:
    """The per-shard layout of a grid with a model axis, else None."""
    if group is None or getattr(group, "model_size", 1) == 1:
        return None
    if leaf_specs is None:
        raise ValueError(
            "a model axis needs the leaves' specs: build(..., leaf_specs="
            "prepend_axis_specs(leaf_specs(bundle), group.axes))")
    if not FL.specs_have_model_axes(leaf_specs, group.axes):
        return None
    return FL.sharded_spec(group, leaf_specs)


def build_engine(spec: ExperimentSpec, *,
                 topology: Optional[Union[Topology, FleetTopology]] = None,
                 schedule: Optional[Union[TopologySchedule,
                                          FleetSchedule]] = None,
                 compress_fn=None, group=None,
                 leaf_specs=None) -> CommRound:
    """Comm-round engine for ``spec``: compressor, mixer (dense, ring or
    packed by ``gossip_mode``, their codec executors under
    ``wire="packed_bits"``, or the fleet mixer under ``fleet=True``; over
    the schedule's table when the spec has one or
    ``schedule`` is given) and backend.  ``compress_fn``: optional
    ``(gen, tree) -> tree`` compression override, refused beside a codec.
    ``group``: an agent group (:mod:`repro_torch.launch.mesh`), one agent a
    rank (a fleet's n / ranks): the executors across processes; with a
    model axis ``leaf_specs`` (the agent axes first) give the per-shard
    layout."""
    _check_group(spec, group)
    return _engine(spec, topology, schedule, compress_fn, group,
                   _sharded(group, leaf_specs))


def _engine(spec, topology, schedule, compress_fn, group, sharded):
    """:func:`build_engine` on the per-shard layout ``sharded`` (None: no
    model axis), worked out once by the caller."""
    if spec.fleet:
        _check_fleet_spec(spec)
        top = resolve_fleet_topology(spec) if topology is None else topology
        sched = (resolve_fleet_schedule(spec, top) if schedule is None
                 else schedule)
        mixer = make_fleet_mixer(sched if sched is not None else top,
                                 group=group)
    else:
        top = resolve_topology(spec) if topology is None else topology
        sched = resolve_schedule(spec, top) if schedule is None else schedule
        mixer = make_mixer(sched if sched is not None else top,
                           spec.gossip_mode, frac=spec.frac,
                           codec=resolve_wire_format(spec), group=group,
                           sharded=sharded)
    return CommRound(compressor=resolve_compressor(spec), mixer=mixer,
                     compress_fn=compress_fn, backend=spec.comm_backend,
                     overlap=spec.overlap,
                     plane_dtype=resolve_plane_dtype(spec),
                     sharded=sharded)


def build(spec: ExperimentSpec, loss_fn, *, device=None,
          topology: Optional[Union[Topology, FleetTopology]] = None,
          compress_fn=None, group=None, leaf_specs=None) -> Algorithm:
    """Resolve ``spec`` into a ready-to-train :class:`Algorithm`.

    loss_fn: ``(params, batch) -> scalar loss`` for one agent, in torch ops
      that ``torch.func`` can differentiate and vmap; wrapped per
      ``spec.remat_policy``.
    device: where the state lives; ``torch.device("cuda")`` unless given
      (under a group, the group's device).
    topology: pre-built Topology (or, under ``fleet=True``, FleetTopology)
      override.
    compress_fn: optional ``(gen, tree) -> tree`` compression override for
      the compressed algorithms (not under a codec).
    group: an :class:`repro_torch.launch.mesh.AgentGroup`, one agent a
      process (the reference's ``mesh=``): the gossip runs across the
      group's ranks, ``init(params)`` returns this rank's agent row, and
      ``step`` takes this rank's batch row and its round's generator (the
      same seed on every rank) and reports metrics over all agents.  Under
      ``fleet=True`` a rank holds k = n / ranks agent rows (n must divide);
      a server algorithm (dp-sgd, soteriafl) takes one client a rank and
      keeps the server's state, the same on every rank.  Neither runs
      beside a model axis (ROADMAP queue 1 item 20).
    leaf_specs: the parameters' specs with the agent axes first (a tree of
      :class:`repro_torch.nn.module.Spec`), needed on a grid with a model
      axis: ``loss_fn`` is then the tensor-parallel loss of this rank's
      shard and ``init(params)`` takes this rank's shard of one replica.
    """
    _check_group(spec, group)
    if device is None:
        device = "cuda" if group is None else group.device
    device = torch.device(device)
    info = algorithm_info(spec.algo)
    loss_fn = apply_remat(loss_fn, spec.remat_policy)
    sharded = _sharded(group, leaf_specs)
    top, sched, comp, mixer, engine, gamma = (None,) * 6
    if info.decentralized:
        if spec.fleet:
            _check_fleet_spec(spec, algo=spec.algo)
            top = (resolve_fleet_topology(spec) if topology is None
                   else topology)
            sched = resolve_fleet_schedule(spec, top)
        else:
            top = resolve_topology(spec) if topology is None else topology
            sched = resolve_schedule(spec, top)
        if (sched is not None and sched.is_directed
                and spec.algo not in _PUSH_SUM_ALGOS):
            raise ValueError(
                f"{spec.algo} assumes doubly-stochastic mixing but "
                f"{spec.topology_schedule!r} is column-stochastic "
                "(directed): without push-sum de-biasing the iterates "
                "drift toward the Perron vector -- use algo='dp-csgp' "
                "for directed topologies")
    if info.decentralized and info.compressed:
        engine = _engine(spec, top, sched, compress_fn, group, sharded)
        comp, mixer = engine.compressor, engine.mixer
    elif info.decentralized:
        if spec.fleet:
            mixer = make_fleet_mixer(sched if sched is not None else top,
                                     group=group)
        else:
            mixer = make_mixer(sched if sched is not None else top,
                               spec.gossip_mode, frac=spec.frac, group=group)
    elif info.compressed:
        # server/client: compression without gossip, the clients a group
        comp = resolve_compressor(spec)
        engine = CommRound(compressor=comp, mixer=None,
                           compress_fn=compress_fn,
                           backend=spec.comm_backend,
                           plane_dtype=resolve_plane_dtype(spec),
                           clients=group)
    if info.decentralized:
        gamma = (resolve_gamma(spec, top, comp, sched) if info.compressed
                 else (1.0 if spec.gamma is None else spec.gamma))
    r = Resolved(info=info, topology=top, compressor=comp, mixer=mixer,
                 engine=engine, gamma=gamma, device=device, schedule=sched,
                 group=group, sharded=sharded)
    return get_factory(spec.algo)(spec, loss_fn, r)


def _require_tau(spec: ExperimentSpec) -> float:
    """DP noise is calibrated to tau's sensitivity: tau=None is an error."""
    if spec.tau is None:
        raise ValueError(f"{spec.algo} is a DP algorithm: its Gaussian "
                         "noise is calibrated to the clipping threshold, "
                         "so tau=None (unclipped) would void the privacy "
                         "guarantee -- set a finite tau")
    return spec.tau


def _bind_init(spec: ExperimentSpec, r: Resolved, init_fn):
    """Uniform ``init(params, n_agents=None, w=None)``: the params go to the
    build's device first.  ``w`` passes through as given: every init
    broadcasts one replica, so W X^0 = X^0 needs no mix.  Under an agent
    group the state holds this rank's rows: ``n_agents`` (if given, all
    agents) becomes 1, or a fleet's k = n / ranks, and the init functions
    that mix by ``w`` take the group (:func:`_grouped`)."""

    def init(params, n_agents: Optional[int] = None, w=None):
        n = spec.n_agents if n_agents is None else n_agents
        if r.group is not None:
            ranks = r.group.n_agents
            if n % ranks or (n != ranks and not spec.fleet):
                raise ValueError(f"init for {n} agents under a group of "
                                 f"{ranks} ranks")
            n //= ranks
        on_device = tree_map(
            lambda p: torch.as_tensor(p).to(r.device), params)
        return init_fn(on_device, n, w)

    return init


def _grouped(init_fn, r: Resolved, **kw):
    """``init_fn`` with ``kw`` bound, and the build's group when there is
    one (the inits that mix replicas by ``w`` keep the rank's row)."""
    if r.group is not None:
        kw["group"] = r.group
    return functools.partial(init_fn, **kw)


def _algorithm(spec, r: Resolved, *, state_cls, init, step,
               config=None) -> Algorithm:
    return Algorithm(name=spec.algo, info=r.info, spec=spec,
                     state_cls=state_cls, init=init, step=step,
                     device=r.device, topology=r.topology,
                     compressor=r.compressor, mixer=r.mixer, engine=r.engine,
                     gamma=r.gamma, config=config, schedule=r.schedule,
                     group=r.group)


def _grad_dtype(spec: ExperimentSpec):
    """The stored gradient's dtype: under bf16 planes g_prev is a bf16
    buffer, so the fresh gradient is cast to it and the state keeps its
    dtypes."""
    pdt = resolve_plane_dtype(spec)
    return spec.buffer_dtype if pdt is None else pdt


def _porter_family(spec: ExperimentSpec, loss_fn, r: Resolved,
                   variant: str, adam: bool = False) -> Algorithm:
    if variant == "gc" and spec.tau is None:
        # unclipped PORTER-GC is BEER (paper Section 4.3)
        variant = "beer"
    pdt = resolve_plane_dtype(spec)
    grad_dtype = _grad_dtype(spec)
    if variant == "beer":
        cfg = beer_config(spec.eta, r.gamma, clip_mode=spec.clip_mode,
                          grad_dtype=grad_dtype)
    else:
        tau = _require_tau(spec) if variant == "dp" else spec.tau
        cfg = PorterConfig(eta=spec.eta, gamma=r.gamma, tau=tau,
                           variant=variant, clip_mode=spec.clip_mode,
                           sigma_p=spec.sigma_p, grad_dtype=grad_dtype)
    if adam:
        step = functools.partial(porter_adam_step, cfg, loss_fn, None, None,
                                 engine=r.engine, b1=spec.b1, b2=spec.b2,
                                 adam_eps=spec.adam_eps)
        init = _bind_init(spec, r, _grouped(porter_adam_init, r,
                                            plane_dtype=pdt))
        return _algorithm(spec, r, state_cls=PorterAdamState, init=init,
                          step=step, config=cfg)
    step = functools.partial(porter_step, cfg, loss_fn, None, None,
                             engine=r.engine)
    init = _bind_init(spec, r, _grouped(
        porter_init, r, buffer_dtype=spec.buffer_dtype, plane_dtype=pdt))
    return _algorithm(spec, r, state_cls=PorterState, init=init, step=step,
                      config=cfg)


@register_algorithm("porter-gc", comm_rounds=2)
def _build_porter_gc(spec, loss_fn, r):
    return _porter_family(spec, loss_fn, r, "gc")


@register_algorithm("porter-dp", dp=True, comm_rounds=2)
def _build_porter_dp(spec, loss_fn, r):
    return _porter_family(spec, loss_fn, r, "dp")


@register_algorithm("beer", comm_rounds=2)
def _build_beer(spec, loss_fn, r):
    return _porter_family(spec, loss_fn, r, "beer")


@register_algorithm("porter-adam", comm_rounds=2)
def _build_porter_adam(spec, loss_fn, r):
    return _porter_family(spec, loss_fn, r, "gc", adam=True)


@register_algorithm("dsgd", compressed=False, comm_rounds=1)
def _build_dsgd(spec, loss_fn, r):
    step = functools.partial(BL.dsgd_step, spec.eta, r.gamma, loss_fn,
                             r.mixer, tau=spec.tau, clip_mode=spec.clip_mode,
                             sigma_p=spec.sigma_p, dp=spec.dp,
                             sharded=r.sharded)
    init = _bind_init(spec, r, lambda params, n, w: BL.dsgd_init(params, n))
    return _algorithm(spec, r, state_cls=BL.DsgdState, init=init, step=step)


@register_algorithm("choco", comm_rounds=1)
def _build_choco(spec, loss_fn, r):
    step = functools.partial(BL.choco_step, spec.eta, r.gamma, loss_fn,
                             None, None, engine=r.engine, tau=spec.tau,
                             clip_mode=spec.clip_mode)
    pdt = resolve_plane_dtype(spec)
    init = _bind_init(
        spec, r,
        lambda params, n, w: BL.choco_init(params, n, plane_dtype=pdt))
    return _algorithm(spec, r, state_cls=BL.ChocoState, init=init, step=step)


@register_algorithm("dp-sgd", dp=True, decentralized=False, compressed=False)
def _build_dpsgd(spec, loss_fn, r):
    tau = _require_tau(spec)

    def step(state, batch, gen, noise=None, clipped=None):
        # the registry feeds agent-stacked batches (n_agents, b, ...), under
        # a group this rank's client's (1, b, ...); the central server
        # pools them into one batch of n*b samples
        rows = spec.n_agents if r.group is None else 1
        lead = {leaf.shape[0] for leaf in tree_leaves(batch)
                if leaf.dim() >= 1}
        if lead != {rows}:
            raise ValueError(
                f"dp-sgd consumes agent-stacked batches with leading dim "
                f"{rows} (n_agents={spec.n_agents}, one client a rank under "
                f"a group); got leading dims {sorted(lead)} -- call "
                "repro_torch.core.baselines.dpsgd_step directly for plain "
                "central batches")
        flat = tree_map(lambda leaf: leaf.reshape((-1,) + leaf.shape[2:])
                        if leaf.dim() >= 2 else leaf, batch)
        return BL.dpsgd_step(spec.eta, loss_fn, state, flat, gen, tau=tau,
                             clip_mode=spec.clip_mode, sigma_p=spec.sigma_p,
                             noise=noise, group=r.group, clipped=clipped)

    # a single server replica: n_agents and w do not apply
    init = _bind_init(spec, r, lambda params, n, w: BL.dpsgd_init(params))
    return _algorithm(spec, r, state_cls=BL.DpSgdState, init=init, step=step)


@register_algorithm("dp-csgp", dp=True, comm_rounds=2)
def _build_dp_csgp(spec, loss_fn, r):
    tau = _require_tau(spec)
    cfg = PorterConfig(eta=spec.eta, gamma=r.gamma, tau=tau, variant="dp",
                       clip_mode=spec.clip_mode, sigma_p=spec.sigma_p,
                       grad_dtype=_grad_dtype(spec))
    step = functools.partial(dp_csgp_step, cfg, loss_fn, None, None,
                             engine=r.engine)
    # the push-sum mirrors start from the round-0 matrix (m = W q has no
    # row-sum shortcut for a column-stochastic W)
    w0 = r.schedule.ws[0] if r.schedule is not None else r.topology.w
    init = _bind_init(spec, r, _grouped(
        dp_csgp_init, r, w0=w0, buffer_dtype=spec.buffer_dtype,
        plane_dtype=resolve_plane_dtype(spec)))
    return _algorithm(spec, r, state_cls=DpCsgpState, init=init, step=step,
                      config=cfg)


@register_algorithm("clip21", comm_rounds=2)
def _build_clip21(spec, loss_fn, r):
    # the residual clip is always piecewise: the smooth factor never
    # reaches 1, so the estimate could never lock onto the gradient
    tau = float("inf") if spec.tau is None else spec.tau
    cfg = PorterConfig(eta=spec.eta, gamma=r.gamma, tau=tau, variant="gc",
                       clip_mode="piecewise", grad_dtype=_grad_dtype(spec))
    step = functools.partial(clip21_step, cfg, loss_fn, None, None,
                             engine=r.engine)
    init = _bind_init(spec, r, _grouped(
        clip21_init, r, buffer_dtype=spec.buffer_dtype,
        plane_dtype=resolve_plane_dtype(spec)))
    return _algorithm(spec, r, state_cls=Clip21State, init=init, step=step,
                      config=cfg)


@register_algorithm("subgrad-comp", comm_rounds=1)
def _build_subgrad(spec, loss_fn, r):
    step = functools.partial(subgrad_step, spec.eta, r.gamma, loss_fn,
                             None, None, engine=r.engine, tau=spec.tau,
                             clip_mode=spec.clip_mode)
    pdt = resolve_plane_dtype(spec)
    init = _bind_init(
        spec, r,
        lambda params, n, w: subgrad_init(params, n, plane_dtype=pdt))
    return _algorithm(spec, r, state_cls=SubgradState, init=init, step=step)


@register_algorithm("soteriafl", dp=True, decentralized=False)
def _build_soteriafl(spec, loss_fn, r):
    tau = _require_tau(spec)
    step = functools.partial(BL.soteria_step, spec.eta, spec.alpha_shift,
                             loss_fn, None, engine=r.engine, tau=tau,
                             clip_mode=spec.clip_mode, sigma_p=spec.sigma_p)
    pdt = resolve_plane_dtype(spec)
    init = _bind_init(
        spec, r,
        lambda params, n, w: BL.soteria_init(params, n, plane_dtype=pdt))
    return _algorithm(spec, r, state_cls=BL.SoteriaState, init=init,
                      step=step)

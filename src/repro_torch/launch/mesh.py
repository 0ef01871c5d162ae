"""Agents as processes: the agent grid and its transport over
``torch.distributed`` (the counterpart of ``src/repro/launch/mesh.py``).

The reference places one agent on each device of a ``("data",)`` or
``("pod", "data")`` mesh axis and gossips with ``shard_map`` collectives.
Here one agent is one process: an :class:`AgentGroup` holds the grid, this
process's agent index (``pod * data_size + data``, the reference's
``_agent_index``), its device and the transport.  Its operations:

* :meth:`AgentGroup.shift` -- every agent sends its tensors to the agent
  ``direction`` places on along the global ring (or along one axis) and
  receives from the agent as far back: one point-to-point exchange
  (``batch_isend_irecv``), counted as one ``collective-permute``;
* :meth:`AgentGroup.all_gather` -- every agent's tensors stacked on a new
  leading agent axis: one ``all-gather``;
* :meth:`AgentGroup.all_reduce_sum` -- one ``all-reduce``, for metrics.

A rank may hold a block of k agent rows rather than one: a fleet's
``n / ranks`` agents (:func:`repro_torch.core.fleet.make_fleet_mixer`
``group=``), rows ``[index * k, (index + 1) * k)`` of the one-card tensor,
rank-major.  ``n_agents`` still counts ranks.

Shift and gather ship the tensors' bytes: every tensor is viewed as
``uint8``, all of a call's tensors go in one message, and the receiver
views the bytes back as each tensor's dtype and shape.  That is the
reference's wire armor (``src/repro/core/gossip.py:602-628``), and it is
also why it is needed here: gloo refuses int16, uint16 and uint32 tensors,
and NCCL has no 16-bit integer type, while the wire buffers hold int16
indices and 32-bit words.  The round trip is exact.

The backend follows a rule (:func:`transport_for`), never a fallback:
``gloo`` on the CPU; ``nccl`` when every rank has a card of its own; gloo
staged through pinned host buffers when ranks share a card (NCCL refuses
two ranks on one device).  ``backend="nccl"`` on a shared card raises.

The model axis: on a ``("data", "model")`` or ``("pod", "data", "model")``
grid an agent's replica is split over ``M = model_size`` ranks (its
tensor-parallel shards, :mod:`repro_torch.nn.tensor_parallel`), ranks
agent-major: ``rank = agent * M + model_index``.  ``shift``,
``all_gather`` and ``all_reduce_sum`` then act along the agent axes among
the ranks of one model index (each of them a process group of its own),
as the reference's agent-axis collectives inside ``shard_map`` do; with
``axis="model"`` ``all_gather`` and ``all_reduce_sum`` act among the ``M``
ranks of one agent.  The census and the transport seconds count each
axis apart (``model_census`` and ``model_transport_s`` for the model
axis).  With ``M = 1`` the grid is the
agent grid alone: the world is the agent group and nothing else is made.

A group comes from torchrun's environment (:meth:`AgentGroup.from_env`) or
from :func:`spawn_agents`, which starts ``world`` processes that meet
through a ``file://`` store, runs ``fn(group, *args)`` in each and joins
them under a timeout: a rank that fails or hangs kills them all and
raises.  Draw sites use :func:`repro_torch.core.agents.local_rows`: a
rank draws the global shape from the round's generator and keeps its own
rows, so a run across processes draws what the one-card run draws.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.agents import agent_rows

__all__ = ["AGENT_AXES", "AgentGroup", "transport_for", "spawn_agents"]

AGENT_AXES = (("data",), ("pod", "data"))
MODEL_AXIS = "model"


def transport_for(device: torch.device, local_world: int,
                  backend: Optional[str] = None) -> Tuple[str, bool]:
    """``(backend, staged)`` for ranks on ``device`` with ``local_world``
    ranks on this host: gloo on the CPU, NCCL when the host has a card for
    every rank, else gloo staged through pinned host buffers.  An explicit
    ``backend`` is checked against that rule, never swapped."""
    device = torch.device(device)
    if device.type == "cpu":
        rule, staged = "gloo", False
    elif torch.cuda.device_count() >= local_world:
        rule, staged = "nccl", False
    else:
        rule, staged = "gloo", True
    if backend is None or backend == rule:
        return rule, staged
    if backend == "nccl":
        raise ValueError(
            f"backend='nccl' needs a card for every rank: {local_world} "
            f"ranks share {torch.cuda.device_count()} card(s) here, and NCCL "
            "refuses two ranks on one device; leave backend unset (gloo, "
            "staged through host buffers)")
    if backend == "gloo" and device.type == "cuda":
        return "gloo", True
    raise ValueError(f"unknown or unsupported backend {backend!r} for "
                     f"{device.type} ranks; have 'gloo', 'nccl'")


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


@dataclasses.dataclass
class AgentGroup:
    """One process's view of the agent grid.

    ``index``: this agent's place on the grid, ``pod * data_size + data``.
    ``sizes``: the grid's extent along each of ``axes``.  ``axes`` may be
    given with a trailing ``"model"`` (``("data", "model")``, ``("pod",
    "data", "model")``): its extent becomes ``model_size`` and ``axes`` /
    ``sizes`` keep the agent axes (``("data",)`` or ``("pod", "data")``).
    ``model_index``: this rank's shard of its agent's replica; the
    process group's rank is ``index * model_size + model_index``.
    ``census`` counts the collectives this process issued along the agent
    axes by category, ``sent_nbytes`` the bytes it put on the wire there
    (a shift's message, a gather's contribution), and ``transport_s`` the
    host seconds spent inside the transport's calls by category (staging
    copies included; on gloo each call returns with its data in place);
    ``model_census`` and ``model_transport_s`` the same along the model
    axis.
    """

    index: int
    sizes: Tuple[int, ...]
    axes: Tuple[str, ...]
    device: torch.device
    backend: str
    staged: bool
    model_size: int = 1
    model_index: int = 0
    census: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    sent_nbytes: int = 0
    transport_s: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    model_census: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    model_transport_s: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    _pinned: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    # process groups: the agent axes among this model index's ranks (None:
    # the world, M = 1) and this agent's M ranks (None when M = 1)
    _agent_pg: Any = dataclasses.field(default=None, repr=False)
    _model_pg: Any = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        axes, sizes = tuple(self.axes), tuple(self.sizes)
        if len(sizes) != len(axes):
            raise ValueError(f"grid sizes {sizes} do not match axes {axes}")
        if axes and axes[-1] == MODEL_AXIS:
            if self.model_size not in (1, sizes[-1]):
                raise ValueError(f"model_size {self.model_size} but the "
                                 f"grid's model axis is {sizes[-1]}")
            self.model_size = int(sizes[-1])
            axes, sizes = axes[:-1], sizes[:-1]
        if axes not in AGENT_AXES:
            raise ValueError(f"agent axes must be one of {AGENT_AXES} (with "
                             f"an optional trailing 'model'); got "
                             f"{self.axes}")
        if self.model_size < 1 or not 0 <= self.model_index < self.model_size:
            raise ValueError(f"model index {self.model_index} outside a "
                             f"model axis of {self.model_size}")
        self.axes, self.sizes = axes, sizes
        self.device = torch.device(self.device)

    @classmethod
    def from_env(cls, grid: Optional[Sequence[int]] = None, device=None,
                 backend: Optional[str] = None, timeout_s: float = 600.0,
                 model: int = 1) -> "AgentGroup":
        """The group of a ``torchrun`` launch (``env://``: ``RANK``,
        ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
        ``MASTER_PORT``).  ``grid``: ``(pod, data)`` sizes, or None for one
        ``data`` axis over the world's agents.  ``model``: the model axis
        (ranks an agent).  ``device``: "cuda" (the default) or "cpu"."""
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        return _join(rank, world, local_rank, local_world, grid,
                     "cuda" if device is None else device, backend,
                     "env://", timeout_s, model)

    # -- the grid ------------------------------------------------------------

    @property
    def rank(self) -> int:
        """This process's rank: agent-major, ``index * model_size +
        model_index``."""
        return self.index * self.model_size + self.model_index

    def _rank_of(self, agent: int) -> int:
        return agent * self.model_size + self.model_index

    @property
    def n_agents(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def agent_axes(self) -> Tuple[str, ...]:
        return self.axes

    def coords(self) -> Dict[str, int]:
        """This agent's coordinate along each axis."""
        if len(self.axes) == 1:
            return {self.axes[0]: self.index}
        dsize = self.sizes[1]
        return {"pod": self.index // dsize, "data": self.index % dsize}

    def neighbour(self, direction: int, axis: Optional[str] = None) -> int:
        """The agent ``direction`` places on from this one: along the
        global ring when ``axis`` is None, else along ``axis`` with the
        other coordinate kept (a wrap inside the pod on ``data``)."""
        if axis is None:
            return (self.index + direction) % self.n_agents
        if len(self.axes) == 1:
            if axis != self.axes[0]:
                raise ValueError(f"no agent axis {axis!r} in {self.axes}")
            return (self.index + direction) % self.n_agents
        c = self.coords()
        pods, dsize = self.sizes
        if axis == "data":
            return c["pod"] * dsize + (c["data"] + direction) % dsize
        if axis == "pod":
            return ((c["pod"] + direction) % pods) * dsize + c["data"]
        raise ValueError(f"no agent axis {axis!r} in {self.axes}")

    def rows(self, full: torch.Tensor, per_agent: Optional[int] = None):
        """This rank's rows of an agent-major tensor: rows ``[index * r,
        (index + 1) * r)`` of ``full``, r = ``per_agent`` or ``len(full) /
        n_agents`` (one agent's rows, or a fleet's block of k = n / ranks
        agents, rank-major as pjit lays a sharded axis out)."""
        return agent_rows(full, self.index, self.n_agents, per_agent)

    # -- the transport -------------------------------------------------------

    def _host(self, tag: str, nbytes: int) -> torch.Tensor:
        """A pinned host staging buffer, kept for the next call of the same
        size."""
        key = (tag, nbytes)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=True)
        return buf

    def _pack(self, tensors: Sequence[torch.Tensor], tag: str):
        """One uint8 message of every tensor's bytes, on the host when the
        transport is staged, and each tensor's (dtype, shape, nbytes)."""
        views = [_byte_view(t) for t in tensors]
        meta = [(t.dtype, tuple(t.shape), v.numel())
                for t, v in zip(tensors, views)]
        total = sum(m[2] for m in meta)
        if self.staged:
            msg = self._host(tag, total)
            off = 0
            for v in views:
                msg[off:off + v.numel()].copy_(v)
                off += v.numel()
        else:
            msg = views[0] if len(views) == 1 else torch.cat(views)
        return msg, meta

    def _unpack(self, msg: torch.Tensor, meta) -> List[torch.Tensor]:
        """Split a received message back into tensors on the device."""
        if self.staged:
            msg = msg.to(self.device)
        out, off = [], 0
        for dtype, shape, nbytes in meta:
            out.append(msg[off:off + nbytes].view(dtype).reshape(shape))
            off += nbytes
        return out

    def shift(self, tensors: Sequence[torch.Tensor], direction: int,
              axis: Optional[str] = None) -> List[torch.Tensor]:
        """Send ``tensors`` to the agent ``direction`` places on and return
        those of the agent ``direction`` places back (agent i - 1's arrive
        at i for ``direction = +1``), in one exchange."""
        t0 = time.perf_counter()
        msg, meta = self._pack(tensors, "send")
        recv = (self._host("recv", msg.numel()) if self.staged
                else torch.empty_like(msg))
        dst = self._rank_of(self.neighbour(direction, axis))
        src = self._rank_of(self.neighbour(-direction, axis))
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, msg, dst),
                                       dist.P2POp(dist.irecv, recv, src)])
        for req in reqs:
            req.wait()
        self.census["collective-permute"] += 1
        self.sent_nbytes += msg.numel()
        out = self._unpack(recv, meta)
        self.transport_s["collective-permute"] += time.perf_counter() - t0
        return out

    def _axis(self, axis: Optional[str]):
        """(process group, members, tag prefix, census, seconds) of the
        agent axes (``axis`` None) or of the model axis."""
        if axis is None:
            return (self._agent_pg, self.n_agents, "", self.census,
                    self.transport_s)
        if axis != MODEL_AXIS:
            raise ValueError(f"collectives run along the agent axes (None) "
                             f"or {MODEL_AXIS!r}; got {axis!r}")
        if self.model_size == 1:
            raise ValueError("this grid has no model axis (model_size 1)")
        return (self._model_pg, self.model_size, "m-", self.model_census,
                self.model_transport_s)

    def all_gather(self, tensors: Sequence[torch.Tensor],
                   axis: Optional[str] = None) -> List[torch.Tensor]:
        """Every agent's ``tensors`` (``axis="model"``: every model
        shard's of this agent), each stacked on a new leading axis in grid
        order, in one all-gather.  A rank's ``(k, ...)`` blocks of agent
        rows come back ``(n_agents, k, ...)``: joined rank-major
        (:func:`repro_torch.core.gossip.gather_blocks`) they are the
        one-card tensor."""
        t0 = time.perf_counter()
        pg, n, tag, census, seconds = self._axis(axis)
        msg, meta = self._pack(tensors, tag + "send")
        if self.staged:
            out = self._host(tag + "gather", n * msg.numel()).view(n, -1)
            dist.all_gather(list(out.unbind(0)), msg, group=pg)
            out = out.to(self.device)
        elif self.backend == "nccl":
            out = torch.empty((n, msg.numel()), dtype=torch.uint8,
                              device=msg.device)
            dist.all_gather_into_tensor(out, msg, group=pg)
        else:
            out = torch.empty((n, msg.numel()), dtype=torch.uint8,
                              device=msg.device)
            dist.all_gather(list(out.unbind(0)), msg, group=pg)
        census["all-gather"] += 1
        if axis is None:
            self.sent_nbytes += msg.numel()
        res, off = [], 0
        for dtype, shape, nbytes in meta:
            res.append(out[:, off:off + nbytes].contiguous().view(dtype)
                       .reshape((n,) + shape))
            off += nbytes
        seconds["all-gather"] += time.perf_counter() - t0
        return res

    def all_reduce_sum(self, x: torch.Tensor,
                       axis: Optional[str] = None) -> torch.Tensor:
        """The sum of ``x`` over every agent (``axis="model"``: over this
        agent's model shards), f32 or f64, on ``x``'s device."""
        t0 = time.perf_counter()
        pg, _, tag, census, seconds = self._axis(axis)
        if self.staged:
            host = self._host(tag + "reduce", x.numel() * x.element_size())
            host = host.view(x.dtype).view(x.shape)
            host.copy_(x.detach())
            dist.all_reduce(host, group=pg)
            out = host.to(x.device)
        else:
            out = x.detach().clone()
            dist.all_reduce(out, group=pg)
        census["all-reduce"] += 1
        seconds["all-reduce"] += time.perf_counter() - t0
        return out


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def _join(rank: int, world: int, local_rank: int, local_world: int,
          grid, device, backend, init_method: str,
          timeout_s: float, model: int = 1) -> AgentGroup:
    device = torch.device(device)
    backend, staged = transport_for(device, local_world, backend)
    if device.type == "cuda":
        # a card of its own under NCCL; the shared card(s) when staged
        device = torch.device("cuda", local_rank if not staged
                              else local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    model = int(model)
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world's {world} ranks")
    sizes = ((world // model,) if grid is None
             else tuple(int(s) for s in grid))
    axes = ("data",) if len(sizes) == 1 else ("pod", "data")
    group = AgentGroup(index=rank // model, sizes=sizes, axes=axes,
                       device=device, backend=backend, staged=staged,
                       model_size=model, model_index=rank % model)
    if group.n_agents * model != world:
        raise ValueError(f"grid {sizes} x model {model} holds "
                         f"{group.n_agents * model} ranks, the world has "
                         f"{world}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": device} if backend == "nccl" else {}))
    if model > 1:
        # every rank makes every group, in one order
        n = group.n_agents
        for m in range(model):
            pg = dist.new_group([a * model + m for a in range(n)])
            if m == group.model_index:
                group._agent_pg = pg
        for a in range(n):
            pg = dist.new_group([a * model + m for m in range(model)])
            if a == group.index:
                group._model_pg = pg
    return group


def _to_host(obj):
    """``obj`` with every CUDA tensor copied to the CPU (results cross to
    the parent pickled by value)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, tuple):
        return type(obj)(*(_to_host(v) for v in obj))
    return obj


def _rank_main(rank, world, store, grid, device, backend, threads,
               timeout_s, env, fn, args, results, model):
    try:
        os.environ.update(env)
        if threads:
            torch.set_num_threads(threads)
        group = _join(rank, world, rank, world, grid, device, backend,
                      f"file://{store}", timeout_s, model)
        try:
            out = fn(group, *args)
            results.put((rank, "ok", pickle.dumps(_to_host(out))))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # reported, then exit 1
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)


def spawn_agents(fn: Callable, world: int, args: Sequence[Any] = (), *,
                 grid: Optional[Sequence[int]] = None, device="cuda",
                 backend: Optional[str] = None, timeout_s: float = 120.0,
                 threads: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None,
                 model: int = 1) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` new processes, one agent
    each (``model`` ranks each on a ``(data, model)`` grid: ``world`` is
    ``n_agents * model``), and return their results in rank order.

    The ranks meet through a ``file://`` store in a fresh temporary
    directory (no ports).  ``fn`` must be importable by name (a module's
    top-level function); its result crosses back pickled, CUDA tensors
    copied to the CPU.  ``grid``: ``(pod, data)`` sizes or None (one
    ``data`` axis).  ``device``: "cuda" (the default) or "cpu".
    ``threads``: each rank's CPU threads (default: the host's cores over
    ``world``, at least 1).  ``env``: variables each rank sets before it
    starts (e.g. ``PYTORCH_CUDA_ALLOC_CONF``, read at a rank's first CUDA
    allocation).  The parent joins every rank under ``timeout_s``; a rank
    that raises, dies or outlasts it gets every rank killed and the call
    raises, naming it.
    """
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    tmp = tempfile.mkdtemp(prefix="agents-")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, store, grid, str(device), backend,
                               threads, timeout_s, dict(env or {}), fn,
                               tuple(args), results, model))
             for r in range(world)]
    out: Dict[int, Any] = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world and failure is None:
            try:
                rank, status, payload = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = (f"ranks {sorted(set(range(world)) - set(out))}"
                               f" did not finish within {timeout_s} s")
                continue
            if status == "ok":
                out[rank] = pickle.loads(payload)
                continue
            # the first failure brings down its peers' collectives too:
            # gather what the others report for a moment, then name all
            failed = {rank: payload}
            grace = time.monotonic() + 2.0
            while time.monotonic() < grace and len(failed) + len(out) < world:
                try:
                    r, st, pl = results.get(timeout=0.2)
                except queue_mod.Empty:
                    continue
                if st == "error":
                    failed[r] = pl
            failure = "\n".join(f"rank {r} failed:\n{tb}"
                                 for r, tb in sorted(failed.items()))
        if failure is None:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
                if p.exitcode != 0:
                    failure = f"a rank exited with code {p.exitcode}"
                    break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"spawn_agents({getattr(fn, '__name__', fn)}, "
                           f"{world}): {failure}")
    return [out[r] for r in range(world)]

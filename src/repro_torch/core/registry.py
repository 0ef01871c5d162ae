"""Algorithm registry: one uniform surface for every decentralized optimizer.

Every algorithm is registered as a factory that :func:`repro_torch.api.build`
turns into an :class:`Algorithm` of one shape:

    state = algo.init(params)                       # on algo.device
    state, metrics = algo.step(state, batch, gen)   # gen: torch.Generator

Every ``step`` emits at least ``loss`` and ``wire_bytes``; decentralized
algorithms add ``consensus_x``.  The registrations live in
:mod:`repro_torch.api`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["Algorithm", "AlgorithmInfo", "register_algorithm",
           "algorithm_info", "get_factory", "list_algorithms"]


@dataclasses.dataclass(frozen=True)
class AlgorithmInfo:
    """Static capabilities of a registered algorithm.

    dp: the gradient oracle clips per sample and adds Gaussian noise.
    decentralized: runs over a communication graph (emits ``consensus_x``).
    compressed: communicates through a rho-compressor (needs a CommRound).
    comm_rounds: gossip exchanges per ``step``.
    """

    name: str
    dp: bool = False
    decentralized: bool = True
    compressed: bool = True
    comm_rounds: int = 1


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A built, ready-to-train algorithm.

    ``init``/``step`` are what a training loop needs; ``device`` is where ``init``
    puts the state and where the runtime makes each round's generators.
    The other fields expose what :func:`repro_torch.api.build` resolved
    (``schedule``: the time-varying topology, None for a static one;
    ``group``: the agent group when every agent is a process, whose
    ``init`` and ``step`` then hold this rank's agent row).
    """

    name: str
    info: AlgorithmInfo
    spec: Any
    state_cls: type
    init: Callable[..., Any]
    step: Callable[..., Tuple[Any, Dict[str, torch.Tensor]]]
    device: torch.device
    topology: Optional[Any] = None
    compressor: Optional[Any] = None
    mixer: Optional[Any] = None
    engine: Optional[Any] = None
    gamma: Optional[float] = None
    config: Optional[Any] = None
    schedule: Optional[Any] = None
    group: Optional[Any] = None


# name -> (info, factory(spec, loss_fn, resolved) -> Algorithm)
_REGISTRY: Dict[str, Tuple[AlgorithmInfo, Callable]] = {}


def _ensure_builtin():
    """The built-in registrations live in repro_torch.api (they need the
    facade's resolvers); import it lazily."""
    import repro_torch.api  # noqa: F401  (registers on import)


def register_algorithm(name: str, *, dp: bool = False,
                       decentralized: bool = True, compressed: bool = True,
                       comm_rounds: Optional[int] = None):
    """Decorator: register ``factory(spec, loss_fn, resolved) -> Algorithm``
    under ``name``."""
    if comm_rounds is None:
        comm_rounds = 1 if decentralized else 0
    if comm_rounds < 0:
        raise ValueError(f"comm_rounds must be >= 0, got {comm_rounds}")
    if not decentralized and comm_rounds:
        raise ValueError(
            f"algorithm {name!r}: centralized algorithms gossip zero times "
            f"per step, got comm_rounds={comm_rounds}")
    info = AlgorithmInfo(name=name, dp=dp, decentralized=decentralized,
                         compressed=compressed, comm_rounds=comm_rounds)

    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"algorithm {name!r} registered twice")
        _REGISTRY[name] = (info, factory)
        return factory

    return deco


def _lookup(name: str) -> Tuple[AlgorithmInfo, Callable]:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; registered: "
                         f"{list_algorithms()}") from None


def algorithm_info(name: str) -> AlgorithmInfo:
    return _lookup(name)[0]


def get_factory(name: str) -> Callable:
    return _lookup(name)[1]


def list_algorithms() -> Tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))

"""The LM train step on one card (``src/repro/launch/steps.py``'s
``TrainSetup`` and ``build_train_step``).

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

The reference's mesh, shardings, shard-local compressor and its prefill and
serve steps belong to the multi-device executors and the launch tooling
(ROADMAP queue 1 items 12 and 14); here every agent lives on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import api
from ..core.porter import PorterConfig
from ..models import ModelBundle, ModelConfig, build_model

__all__ = ["TrainSetup", "build_train_step"]


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
    device=None,
) -> TrainSetup:
    """The train step of ``cfg`` over ``n_agents`` agents on ``device``
    (cuda unless given).

    variant: a key of the reference's ``VARIANT_TO_ALGO`` ('gc', 'dp',
    'beer', 'csgp'), or a registered algorithm's name.  ``comm_backend``
    'auto' runs the ef kernels on the card; ``plane_dtype`` 'bf16' keeps
    the six EF planes in bf16 beside f32 master parameters;
    ``remat_policy`` None, 'full' or 'dots' (:mod:`repro_torch.core.remat`);
    ``fleet`` mixes all agents on one axis (:mod:`repro_torch.core.fleet`).
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    bundle = build_model(cfg, device=device)
    algo_name = api.VARIANT_TO_ALGO.get(variant, variant)
    spec = api.ExperimentSpec(
        algo=algo_name, n_agents=n_agents, topology=topology_kind,
        topology_weights="metropolis", topology_schedule=topology_schedule,
        compressor=compressor_name, frac=frac, comm_backend=comm_backend,
        eta=eta, tau=tau, sigma_p=sigma_p, plane_dtype=plane_dtype,
        remat_policy=remat_policy, fleet=fleet)
    algo = api.build(spec, bundle.loss, device=device)
    return TrainSetup(cfg=cfg, bundle=bundle, algorithm=algo,
                      n_agents=n_agents, porter_cfg=algo.config,
                      device=device)

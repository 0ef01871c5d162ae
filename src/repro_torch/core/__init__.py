"""The paper's algorithms and their substrate: PORTER-GC/DP and BEER
(``porter``, ``beer``), the baselines DSGD, CHOCO-SGD, DP-SGD and SoteriaFL
(``baselines``), and beyond the paper PORTER-Adam (``porter_adam``),
Clip21 (``clip21``), the compressed subgradient method (``subgrad``) and
DP-CSGP with push-sum (``push_sum``), over the comm-round engine and the
static or time-varying mixers (``comm_round``, ``gossip``, ``mixing``), and
fleet-scale agents (``fleet``: sparse COO topologies and schedules and the
fleet mixer)."""

from .fleet import (FLEET_DENSE_GATE, FleetSchedule, FleetTopology,
                    fleet_er_schedule, fleet_rotating_schedule,
                    fleet_topology, make_fleet_mixer)
from .porter import (PorterConfig, PorterState, average_params,
                     consensus_error, porter_init, porter_step)

__all__ = ["PorterConfig", "PorterState", "average_params",
           "consensus_error", "porter_init", "porter_step",
           "FLEET_DENSE_GATE", "FleetTopology", "FleetSchedule",
           "fleet_topology", "fleet_rotating_schedule", "fleet_er_schedule",
           "make_fleet_mixer"]

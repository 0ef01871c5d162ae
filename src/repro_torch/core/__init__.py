"""The paper's algorithms and their substrate: PORTER-GC/DP and BEER
(``porter``, ``beer``), the baselines DSGD, CHOCO-SGD, DP-SGD and SoteriaFL
(``baselines``), over the dense comm-round engine."""

from .porter import (PorterConfig, PorterState, average_params,
                     consensus_error, porter_init, porter_step)

__all__ = ["PorterConfig", "PorterState", "average_params",
           "consensus_error", "porter_init", "porter_step"]

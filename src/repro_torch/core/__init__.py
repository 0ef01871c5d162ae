"""The paper's algorithms and their substrate: PORTER-GC/DP and BEER
(``porter``, ``beer``), the baselines DSGD, CHOCO-SGD, DP-SGD and SoteriaFL
(``baselines``), and beyond the paper PORTER-Adam (``porter_adam``),
Clip21 (``clip21``), the compressed subgradient method (``subgrad``) and
DP-CSGP with push-sum (``push_sum``), over the comm-round engine and the
static or time-varying mixers (``comm_round``, ``gossip``, ``mixing``)."""

from .porter import (PorterConfig, PorterState, average_params,
                     consensus_error, porter_init, porter_step)

__all__ = ["PorterConfig", "PorterState", "average_params",
           "consensus_error", "porter_init", "porter_step"]

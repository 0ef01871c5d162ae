"""The paper's algorithms and their substrate (this slice: PORTER-GC/DP and
BEER over the dense comm-round engine)."""

from .porter import (PorterConfig, PorterState, average_params,
                     consensus_error, porter_init, porter_step)

__all__ = ["PorterConfig", "PorterState", "average_params",
           "consensus_error", "porter_init", "porter_step"]

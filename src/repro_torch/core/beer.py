"""BEER [ZLL+22] -- the unclipped ancestor of PORTER (paper Section 4.3):
PORTER-GC without the clipping operator."""

from __future__ import annotations

from .porter import PorterConfig

__all__ = ["beer_config"]


def beer_config(eta: float, gamma: float, **kwargs) -> PorterConfig:
    """PorterConfig pinned to the BEER point of the algorithm family.

    ``variant`` and ``tau`` are what make BEER (no clipping), so a caller's
    values for them are rejected rather than ignored.
    """
    for fixed in ("variant", "tau"):
        if fixed in kwargs:
            raise ValueError(
                f"beer_config fixes {fixed!r} (BEER is unclipped PORTER); "
                f"got {fixed}={kwargs[fixed]!r} -- use PorterConfig directly "
                "for a clipped variant")
    return PorterConfig(eta=eta, gamma=gamma, variant="beer", tau=float("inf"),
                        **kwargs)

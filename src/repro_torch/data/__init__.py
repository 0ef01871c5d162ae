"""Data: synthetic datasets (numpy) and on-device batch sources."""

from .batch_source import (dirichlet_partition, dirichlet_source,
                           minibatch_source)
from .synthetic import a9a_like, mnist_like, shard_to_agents

__all__ = ["a9a_like", "mnist_like", "shard_to_agents", "minibatch_source",
           "dirichlet_partition", "dirichlet_source"]

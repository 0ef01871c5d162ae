"""Data: synthetic datasets (numpy), LM token batches and on-device batch
sources."""

from .batch_source import (batch_source, dirichlet_partition,
                           dirichlet_source, minibatch_source)
from .synthetic import a9a_like, mnist_like, shard_to_agents, token_batch

__all__ = ["a9a_like", "mnist_like", "shard_to_agents", "token_batch",
           "batch_source", "minibatch_source", "dirichlet_partition",
           "dirichlet_source"]

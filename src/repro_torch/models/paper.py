"""The paper's Section-5.2 model: 784 -> 64 sigmoid -> 10 softmax
cross-entropy (``src/repro/models/paper.py``)."""

from __future__ import annotations

import torch

from ..configs.paper_mnist import CLASSES, HIDDEN, INPUT_DIM

__all__ = ["mlp_init", "mlp_loss"]


def mlp_init(seed: int = 0, scale: float = 0.05, device=None):
    """Initial parameters of the Section-5.2 MLP (zero biases, Gaussian
    weights scaled by ``scale``).  Drawn on the CPU from ``seed`` and moved
    to ``device`` (cuda unless given), so every device gets the same values;
    they are not the reference's draws (use :mod:`repro_torch.convert` to
    carry those across)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {"w1": scale * torch.randn(INPUT_DIM, HIDDEN, generator=gen),
              "c1": torch.zeros(HIDDEN),
              "w2": scale * torch.randn(HIDDEN, CLASSES, generator=gen),
              "c2": torch.zeros(CLASSES)}
    return {k: v.to(device) for k, v in params.items()}


def mlp_loss():
    """Per-agent loss ``(params, (features, labels)) -> scalar`` of the
    Section-5.2 MLP (softmax cross-entropy)."""

    def loss_fn(params, batch):
        f, labels = batch
        f = torch.atleast_2d(f)
        labels = torch.atleast_1d(labels).long()
        h = torch.sigmoid(f @ params["w1"] + params["c1"])
        logits = h @ params["w2"] + params["c2"]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return torch.mean(lse - gold)

    return loss_fn

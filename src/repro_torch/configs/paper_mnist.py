"""The paper's Section-5.2 experiment protocol: one-hidden-layer MLP
(784 -> 64 sigmoid -> 10 softmax-CE) on MNIST-shaped data, same
decentralized setup as Section 5.1; a copy of
``src/repro/configs/paper_mnist.py``."""

from .paper_logreg import BATCH, GRAPH, N_AGENTS, PRIVACY_LEVELS, RHO, TAU

INPUT_DIM = 784
HIDDEN = 64
CLASSES = 10

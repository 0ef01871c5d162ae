"""The paper's Section-5.1 experiment protocol (logistic regression with
nonconvex regularization on a9a-shaped data); a copy of
``src/repro/configs/paper_logreg.py``."""

N_AGENTS = 10
GRAPH = dict(kind="erdos_renyi", p=0.8, weights="best_constant", seed=1)
DIM = 123                  # a9a feature dimension
LAMBDA = 0.2               # nonconvex regularizer weight
RHO = 0.05                 # random-5% sparsification (paper: k = d/20)
TAU = 1.0
BATCH = 1
PRIVACY_LEVELS = [(1e-2, 1e-3), (1e-1, 1e-3)]   # (epsilon, delta)

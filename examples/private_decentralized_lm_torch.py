"""End-to-end driver on the PyTorch port (the counterpart of
``examples/private_decentralized_lm.py``): train a transformer LM
decentralized and privately.

Four agents train a reduced TinyLlama-family model with PORTER-DP:
per-sample smooth clipping, Theorem-1-calibrated Gaussian perturbation for
a (0.5, 1e-3)-LDP target, top-5% compressed gossip over a ring.  The
per-sample gradients go in chunks whose per-sample plane stays within
``repro_torch.core.clipping.SAMPLE_PLANE_BYTES``.

    PYTHONPATH=src python examples/private_decentralized_lm_torch.py
    PYTHONPATH=src python examples/private_decentralized_lm_torch.py \\
        --steps 3 --device cpu

It runs on the card unless ``--device cpu`` is given.  ``--big`` takes the
full 22-layer tinyllama-1.1b, which needs more than one card's 80 GB: four
agents' seven f32 state trees of 1.1 B parameters come to about 123 GB.
On one H100 the 2-of-22-layer cell of ``chip_smoke.py`` (phase 13) stands
in for it.
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.api import ExperimentSpec, build
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.privacy import calibrate_sigma, ldp_epsilon
from repro_torch.data import batch_source
from repro_torch.launch.runtime import run_chunked
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=60)
ap.add_argument("--chunk", type=int, default=20,
                help="comm rounds a chunk between host syncs")
ap.add_argument("--agents", type=int, default=4)
ap.add_argument("--batch", type=int, default=2)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--epsilon", type=float, default=0.5)
ap.add_argument("--delta", type=float, default=1e-3)
ap.add_argument("--samples-per-agent", type=int, default=8192)
ap.add_argument("--big", action="store_true", help="full tinyllama-1.1b")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
device = torch.device(args.device)

cfg = get_config("tinyllama-1.1b") if args.big else \
    dataclasses.replace(get_smoke("tinyllama-1.1b"), n_layers=2, d_model=128,
                        d_ff=352, n_heads=4, n_kv_heads=2, vocab=1024)
cfg = dataclasses.replace(cfg, remat=False)
bundle = build_model(cfg, device=device)
params = bundle.init(torch.Generator(device=device).manual_seed(0))
n_params = sum(leaf.numel() for leaf in tree_leaves(params))

# --- privacy calibration (Theorem 1) ----------------------------------------
tau = 1.0
sigma_p = calibrate_sigma(tau, args.steps, args.samples_per_agent,
                          args.epsilon, args.delta)
eps_acct = ldp_epsilon(tau, sigma_p, args.steps, args.samples_per_agent,
                       args.delta, b=args.batch)
print(f"model: {n_params/1e6:.1f}M params | agents: {args.agents} | "
      f"sigma_p = {sigma_p:.4g} for ({args.epsilon},{args.delta})-LDP "
      f"(accountant says eps = {eps_acct:.3g})")

# --- PORTER-DP over a ring ----------------------------------------------------
spec = ExperimentSpec(algo="porter-dp", n_agents=args.agents,
                      topology="ring", compressor="top_k", frac=0.05,
                      eta=5e-2, tau=tau, sigma_p=sigma_p)
algo = build(spec, bundle.loss, device=device)
state = algo.init(params)
source = batch_source(cfg, args.agents, args.batch, args.seq, device=device)

t0 = time.time()
span = {"first": None, "last": None}


def report(ts, te, st, m):
    # one host sync a chunk; the batches were drawn on the device
    loss = m["loss"].cpu()
    consensus = m["consensus_x"].cpu()
    if span["first"] is None:
        span["first"] = float(loss[0])
    span["last"] = float(loss[-1])
    for i, t in enumerate(range(ts, te)):
        if t % 20 == 0 or t == args.steps - 1:
            print(f"step {t:4d}  loss {float(loss[i]):.4f}  "
                  f"consensus {float(consensus[i]):.2e}  "
                  f"({time.time()-t0:.1f}s)")


run_chunked(algo, source, state, 1, args.steps, chunk=args.chunk,
            on_chunk=report, donate=True)
first, last = span["first"], span["last"]

print(f"\nloss {first:.3f} -> {last:.3f}; every gradient an agent ever "
      f"shared was clipped to tau={tau} and perturbed: the run is "
      f"({args.epsilon},{args.delta})-LDP end to end.")

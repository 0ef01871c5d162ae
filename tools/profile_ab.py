"""Device busy share, kernel launches a round and the port's kernels' µs a
round of PORTER-GC and PORTER-DP (f32, kernel backend) on the full-width
MLP, for the port in a given source tree, on one card: ``chip_smoke.py``
phase 4's ``profile_rounds`` (20 rounds under ``torch.profiler`` after two
warm ones), on the same problem.

    python3 tools/profile_ab.py [--src SRC] [--label LABEL] [--rounds N]

SRC is the ``src`` directory of a checkout (default: this checkout's), so
two commits can be compared on one card in one call: unpack the other
commit into a git-ignored directory (``git archive``) and run the script
once per tree, in turns (A, B, B, A).  Each run imports ``repro_torch``
from SRC and builds that tree's kernels into its own ``build/``; it prints
``chip_smoke.py``'s two ``[profile]`` lines a configuration, labelled.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"porter-gc f32 kernel": {},
           "porter-dp f32 kernel": dict(algo="porter-dp", sigma_p=0.01)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_ab.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import api, data
    from repro_torch.launch import runtime
    from repro_torch.models import paper
    source, base, loss_fn = cs._mlp_problem(api, data, paper, 60000)
    for name, over in CONFIGS.items():
        algo = cs._build(api, base.replace(comm_backend="kernel", **over),
                         loss_fn)
        cs.profile_rounds(torch, runtime, algo, source, cs._init(algo, paper),
                          args.rounds, f"{args.label} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

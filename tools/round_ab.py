"""ms per round of PORTER-GC, PORTER-DP, CHOCO and the DP baselines (DSGD
with DP, DP-SGD, SoteriaFL in f32 and with bf16 planes) on the full-width MLP,
for the port in a given source tree, on one card: what ``chip_smoke.py``
phase 4 runs (Section 5.2, 10 agents, ER(0.8), top-k 5 %, batch 8; and
PORTER-GC with the ``block_top_k`` compressor at 5 %; PORTER-GC and CHOCO
with bf16 EF planes; PORTER-GC over the bit-packed wire with QSGD at 7
levels, the path of ``qsgd_pack``; and phase 9's PORTER-GC on a static
and an ``erdos_renyi`` schedule, porter-adam and dp-csgp on a random
digraph), timed the same way (host wall clock from the end of
the first 50-round chunk to the end of the last, each chunk ended by a
synchronize).  Each configuration also prints a SHA-256 digest of its final
state (every buffer, after the last repeat; each repeat starts from the
same seed), so two trees that compute bitwise alike print the same
digests.

    python3 tools/round_ab.py [--src SRC] [--label LABEL] [--rounds N]
                              [--repeats N] [--only NAME,...]

SRC is the ``src`` directory of a checkout (default: this checkout's), so
two commits can be compared on one card in one call: unpack the other
commit into a git-ignored directory (``git archive``) and run the script
once per tree, in turns (A, B, B, A).  Each run imports ``repro_torch``
from SRC, builds that tree's kernels into its own ``build/``, and prints
one ``[round-ab]`` line per configuration and a JSON line of medians.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"porter-gc kernel": dict(comm_backend="kernel"),
           "porter-gc ref": dict(comm_backend="ref"),
           "porter-dp kernel": dict(algo="porter-dp", sigma_p=0.01,
                                    comm_backend="kernel"),
           "porter-gc block_top_k kernel": dict(compressor="block_top_k",
                                                comm_backend="kernel"),
           "porter-gc bf16 kernel": dict(plane_dtype="bf16",
                                         comm_backend="kernel"),
           "choco bf16 kernel": dict(algo="choco", plane_dtype="bf16",
                                     comm_backend="kernel"),
           "porter-gc qsgd kernel": dict(wire="packed_bits",
                                         gossip_mode="packed",
                                         compressor="qsgd",
                                         compressor_kwargs={"levels": 7},
                                         comm_backend="kernel"),
           "porter-gc static schedule kernel": dict(
               topology_schedule="static", comm_backend="kernel"),
           "porter-gc erdos_renyi schedule kernel": dict(
               topology_schedule="erdos_renyi:period=8",
               comm_backend="kernel"),
           "porter-adam kernel": dict(algo="porter-adam", eta=0.002,
                                      comm_backend="kernel"),
           "dp-csgp digraph kernel": dict(
               algo="dp-csgp", sigma_p=0.01, comm_backend="kernel",
               topology_schedule="directed:digraph,p=0.5,period=8"),
           "dsgd-dp": dict(algo="dsgd", dp=True, sigma_p=0.01),
           "dp-sgd": dict(algo="dp-sgd", sigma_p=0.01),
           "soteriafl": dict(algo="soteriafl", sigma_p=0.01),
           "soteriafl bf16": dict(algo="soteriafl", sigma_p=0.01,
                                  plane_dtype="bf16")}


def _digest(torch, tree_leaves, state) -> str:
    """SHA-256 of the bytes of every buffer of a state."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tuple(state)):
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--only", default=",".join(CONFIGS),
                    help="comma-separated configurations to run")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    unknown = set(only) - set(CONFIGS)
    if unknown:
        ap.error(f"unknown configurations: {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("round_ab.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import api, data
    from repro_torch.launch import runtime
    from repro_torch.models import paper
    from repro_torch.tree import tree_leaves
    import repro_torch
    print(f"[round-ab] {args.label}: repro_torch from "
          f"{Path(repro_torch.__file__).parent}, "
          f"{torch.cuda.get_device_name(0)}")
    source, base, loss_fn = cs._mlp_problem(api, data, paper, 60000)
    medians, digests = {}, {}
    for name in only:
        algo = cs._build(api, base.replace(**CONFIGS[name]), loss_fn)
        times = []
        for _ in range(args.repeats):
            state, losses, ms = cs.run_timed(
                torch, runtime.run_chunked, algo, source,
                cs._init(algo, paper), 0, args.rounds, 50)
            times.append(ms)
        medians[name] = statistics.median(times)
        digests[name] = _digest(torch, tree_leaves, state)
        print(f"[round-ab] {args.label} {name}: ms/round {times}, loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}, final state "
              f"{digests[name]}")
    print(json.dumps({"label": args.label, "ms_per_round": medians,
                      "final_state": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

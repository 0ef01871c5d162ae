"""Seconds of ``chip_smoke.py`` phase 15 (agents as processes) for the
port in a given checkout, on one card: that checkout's phase 4 and phase
10 first (the runs a newer phase 15 holds its own against), then
phase 15, and a ``[phase15-ab]`` line with its seconds, its MLP part and
its LM part.

    python3 tools/phase15_ab.py TREE LABEL

TREE is the root of a checkout (this one, or another commit unpacked into
a git-ignored directory with ``git archive``; give an absolute path: the
spawned ranks re-run this file from the checkout's root).  Run it once a
tree in one call, in turns (A, B, B, A): hosts differ 1.1-1.4x between
calls.  Each run builds that tree's kernels into its own ``build/``.
"""

import inspect
import os
import sys
import time

TREE, LABEL = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, TREE)
sys.path.insert(0, os.path.join(TREE, "src"))
os.chdir(TREE)
import chip_smoke as C  # noqa: E402  (the checkout's own)


def main():
    import torch
    from repro_torch import api, configs, data
    from repro_torch.kernels import build, flatten, ops, ref
    from repro_torch.launch import mesh, runtime, steps
    from repro_torch.models import paper
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    build.build_all()
    print(f"[phase15-ab {LABEL}] build {time.perf_counter() - t0:.1f} s",
          flush=True)
    out4 = C.phase_baselines(torch, ops, api, data, runtime, paper)
    # a newer phase 15 takes phase 4's and phase 10's kept states
    new = "server_x" in inspect.signature(C.phase_agents_mlp).parameters
    if new:
        fleet_x, fleet_ms = {}, {}
        fleet_x[C.FLEET_N], fleet_ms = C.phase_fleet_runs(
            torch, ops, ref, api, data, runtime, flatten, tree_leaves)
        below, fleet_ms[f"n={C.FLEET_BELOW} porter-gc"] = (
            C.phase_fleet_below_gate(torch, ops, api, data, runtime,
                                     tree_leaves))
        fleet_x[C.FLEET_BELOW] = {"porter-gc": below}
    else:
        C.phase_fleet_runs(torch, ops, ref, api, data, runtime, flatten,
                           tree_leaves)
        C.phase_fleet_below_gate(torch, ops, api, data, runtime, tree_leaves)
    t15 = time.perf_counter()
    if new:
        agents = C.phase_agents_mlp(torch, ops, api, data, runtime, paper,
                                    mesh, tree_leaves, out4[1])
        mlp = time.perf_counter()
        agents["lm"] = C.phase_agents_lm(torch, ops, runtime, steps, data,
                                         configs, mesh, tree_leaves, fleet_x,
                                         fleet_ms)
    else:
        agents = C.phase_agents_mlp(torch, ops, api, data, runtime, paper,
                                    mesh, tree_leaves)
        mlp = time.perf_counter()
        agents["lm"] = C.phase_agents_lm(torch, ops, runtime, steps, data,
                                         configs, mesh, tree_leaves)
    end = time.perf_counter()
    print(f"[phase15-ab {LABEL}] phase 15 took {end - t15:.1f} s: MLP part "
          f"{mlp - t15:.1f} s, LM part {end - mlp:.1f} s", flush=True)


if __name__ == "__main__":
    main()

"""``chip_smoke.py`` phase 15's MLP runs (10 ranks on one card, gloo
staged through pinned host buffers) with two forms of the staged pack of
``launch/mesh.AgentGroup._pack``: this tree's (a blocking copy into the
pinned message a tensor) and "one-wait" (every tensor's copy enqueued,
then one wait on the stream).  Prints each run's ms a round on rank 0 and
its timed seconds, and their sum, a spawn each form.

    python3 tools/pack_ab.py [--order tree,one-wait]

The forms run in the order given, in one call (repeat a form to take it
in turns).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as C  # noqa: E402


def _one_wait_pack(self, tensors, tag):
    """The staged pack with one stream wait a message."""
    import torch
    views = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    meta = [(t.dtype, tuple(t.shape), v.numel())
            for t, v in zip(tensors, views)]
    if not self.staged:
        return (views[0] if len(views) == 1 else torch.cat(views)), meta
    msg = self._host(tag, sum(m[2] for m in meta))
    off = 0
    for v in views:
        msg[off:off + v.numel()].copy_(v, non_blocking=True)
        off += v.numel()
    torch.cuda.current_stream(self.device).synchronize()
    return msg, meta


def mlp_rank(group, labels, form):
    if form == "one-wait":
        from repro_torch.launch import mesh
        mesh.AgentGroup._pack = _one_wait_pack
    return C.agents_mlp_rank(group, labels)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--order", default="tree,one-wait")
    args = parser.parse_args()
    from repro_torch.kernels import build
    from repro_torch.launch import mesh
    build.build_all()
    labels = list(C.AGENTS_RUNS)
    for form in args.order.split(","):
        t0 = time.perf_counter()
        ranks = mesh.spawn_agents(mlp_rank, C.AGENTS_RANKS, (labels, form),
                                  device="cuda",
                                  timeout_s=3 * C.AGENTS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        per_run = {label: (ranks[0][label]["ms"],
                           ranks[0][label]["ms"] * C.AGENTS_RUNS[label][2]
                           / 1e3) for label in labels}
        print(f"[pack-ab] {form}: {wall:.1f} s spawn to join; rank-0 ms a "
              f"round and timed seconds {json.dumps(per_run)}; sum "
              f"{sum(v[1] for v in per_run.values()):.1f} s", flush=True)


if __name__ == "__main__":
    main()

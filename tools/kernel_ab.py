"""Device µs of ``ssd_chunk`` and ``block_topk``, and optionally the
zamba2-7b prefill, for the port in a given source tree, on one card: the
kernels at the shapes ``chip_smoke.py`` phases 7 and 8 time (the SSD scan
at 4 x 512 tokens, 112 heads x 64, state 64, bf16 and f32 B / C, and at 2 x
4096 tokens; the top-k on 250 windows and on 8,192 windows of 2048, k =
102, f32 and bf16), each from CUDA events over inputs that exceed L2, and
the prefill as ``launch.serve.generate`` times it (batch 4 x prompt 512,
synchronized wall clock, median of 3 after a warm call).

    python3 tools/kernel_ab.py [--src SRC] [--label LABEL] [--prefill]

SRC is the ``src`` directory of a checkout (default: this checkout's), so
two commits can be compared on one card in one call: unpack the other
commit into a git-ignored directory (``git archive``) and run the script
once per tree, in turns (A, B, B, A).  Each run imports ``repro_torch``
from SRC, builds that tree's kernels into its own ``build/``, and prints
one ``[kernel-ab]`` line per measurement and a JSON line of them all.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SSD_CELLS = {"ssd path bf16": ((4, 512, 112, 64, 64), "bf16"),
             "ssd path f32": ((4, 512, 112, 64, 64), "f32"),
             "ssd 2x4096 bf16": ((2, 4096, 112, 64, 64), "bf16")}
TOPK_CELLS = {"block_topk 250 f32": (250, "f32"),
              "block_topk 250 bf16": (250, "bf16"),
              "block_topk 8192 f32": (8192, "f32")}
TOPK_K = 102


def _sets(cs, make, first_bytes):
    """Enough input sets to exceed L2 between two calls on the same one."""
    n_sets = -(-cs.L2_FLUSH_BYTES // first_bytes) + 1
    return [make() for _ in range(n_sets)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import ops
    print(f"[kernel-ab] {args.label}: repro_torch from "
          f"{Path(repro_torch.__file__).parent}, "
          f"{torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(12)
    us = {}
    with torch.inference_mode():
        for name, (shape, bc) in SSD_CELLS.items():
            first = cs._ssd_inputs(torch, gen, shape, bc)
            moved = (sum(t.nbytes for t in first)       # + y and h_final
                     + first[0].nbytes + first[4].nbytes)
            sets = _sets(cs, lambda: cs._ssd_inputs(torch, gen, shape, bc),
                         moved)
            us[name] = 1e3 * cs.device_time_ms(ops.ssd_scan, sets, 10, 5)
            print(f"[kernel-ab] {args.label} {name} {shape}: {us[name]:.3f} "
                  f"us")
            del sets, first
        for name, (windows, dt) in TOPK_CELLS.items():
            dtype = torch.float32 if dt == "f32" else torch.bfloat16

            def make():
                return [torch.randn(windows, cs.PACK_BLOCK, generator=gen,
                                    device="cuda").to(dtype), TOPK_K]
            nbytes = 2 * windows * cs.PACK_BLOCK * (4 if dt == "f32" else 2)
            sets = _sets(cs, make, nbytes)
            us[name] = 1e3 * cs.device_time_ms(ops.block_topk, sets, 20, 10)
            print(f"[kernel-ab] {args.label} {name} k={TOPK_K}: "
                  f"{us[name]:.3f} us")
            del sets
    prefill = None
    if args.prefill:
        from repro_torch.launch import serve
        sc = cs.ZAMBA_SERVE
        cfg, bundle, params = serve.load("zamba2-7b", device="cuda", seed=0)
        tokens = serve.make_prompt(cfg, sc["batch"], sc["prompt"], "cuda", 1)
        serve.generate(bundle, params, tokens, 1)     # warm
        times = [1e3 * serve.generate(bundle, params, tokens, 1)["prefill_s"]
                 for _ in range(3)]
        prefill = statistics.median(times)
        print(f"[kernel-ab] {args.label} zamba2-7b prefill batch "
              f"{sc['batch']} x {sc['prompt']}: ms {times}, median "
              f"{prefill:.3f} = {sc['batch'] * sc['prompt'] / prefill * 1e3:.1f}"
              f" tok/s")
    print(json.dumps({"label": args.label, "us": us,
                      "zamba2_prefill_ms": prefill}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

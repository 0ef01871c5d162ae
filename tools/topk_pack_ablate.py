"""Where the time of ``topk_pack`` (``csrc/wire_pack.cu``) goes: device µs
of the kernel on the MLP's 280 codec rows (k = 102, Gaussian windows) and
of copies of its sources (``wire_pack.cu`` and ``radix_select.cuh``) with
a part cut out or changed.  The changed copies give wrong outputs; only
their times are read.

    python3 tools/topk_pack_ablate.py [--rounds N]

Builds every variant with ``nvcc`` at once into the git-ignored
``build/tools/topk_pack_ablate/``, loads each with ``ctypes`` (the
kernel's own C interface) and times them in turns, ``--rounds`` times,
from CUDA events over inputs that exceed L2.  Prints one ``[ablate]`` line
a variant and round, then a JSON line of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tools" / "topk_pack_ablate"
ROWS, K = 280, 102

SELECT = """  const radix_select::Found f =
      radix_select::select<float>(raw, k, hist4, t, lane);"""
NO_SELECT = "  const radix_select::Found f{top, 0, 1, 0};"
BISECT = """#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (mid <= a_k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }"""
NO_BISECT = "  lo = a_k;\n  (void)hi;"
PASS0_ADD = "        atomicAdd(hb + ((key >> shift) & mask), 1);"
SPREAD_ADD = ("        atomicAdd(hb + (((key >> shift) & mask) ^ "
              "(pass == 0 ? (lane & 7) : 0)), 1);")

# name -> (note, [(file, text in it, replacement)])
VARIANTS = {
    "full": ("the kernel as it is", []),
    "no select": ("the radix select (a_k taken as the warp's max key: no "
                  "digit pass, no bucket minimum)",
                  [("wire_pack.cu", SELECT, NO_SELECT)]),
    "no bisection": ("the 24 scalar steps (lo = a_k)",
                     [("wire_pack.cu", BISECT, NO_BISECT)]),
    "floor": ("both: the launch, the loads, the max, the compaction and "
              "the writes", [("wire_pack.cu", SELECT, NO_SELECT),
                             ("wire_pack.cu", BISECT, NO_BISECT)]),
    "pass 0 spread": ("pass 0's histogram adds spread over 8 bins by lane "
                      "(a lane's bin XOR lane % 8): the same adds with an "
                      "eighth of the same-address conflicts",
                      [("radix_select.cuh", PASS0_ADD, SPREAD_ADD)]),
}


def _build(build):
    procs = {}
    for i, (name, (_, cuts)) in enumerate(VARIANTS.items()):
        texts = {f: (build.CSRC / f).read_text()
                 for f in ("wire_pack.cu", "radix_select.cuh")}
        for f, old, new in cuts:
            if old not in texts[f]:
                raise RuntimeError(f"{name}: cut not found in {f}")
            texts[f] = texts[f].replace(old, new)
        out = OUT / f"v{i}"
        out.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (out / f).write_text(text)
        lib = out / "libtopk.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(out / "wire_pack.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        so = ctypes.CDLL(str(lib))
        so.topk_pack.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                         ctypes.c_int,
                                                         ctypes.c_void_p]
        so.topk_pack.restype = ctypes.c_int
        libs[name] = so
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("topk_pack_ablate.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    libs = _build(build)
    gen = torch.Generator(device="cuda").manual_seed(7)
    n_sets = -(-cs.L2_FLUSH_BYTES // (ROWS * cs.PACK_BLOCK * 4)) + 1
    sets = [[torch.randn(ROWS, cs.PACK_BLOCK, generator=gen, device="cuda")]
            for _ in range(n_sets)]
    vals = torch.empty(ROWS, K, dtype=torch.bfloat16, device="cuda")
    idx = torch.empty(ROWS, K, dtype=torch.int16, device="cuda")
    times = {name: [] for name in VARIANTS}
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            def call(x, lib=lib):
                err = lib.topk_pack(x.data_ptr(), vals.data_ptr(),
                                    idx.data_ptr(), ROWS, K,
                                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"topk_pack launch failed: {err}")
            us = 1e3 * cs.device_time_ms(call, sets, 20, 10)
            times[name].append(us)
            print(f"[ablate] round {rnd} {name}: {us:.3f} us "
                  f"({VARIANTS[name][0]})")
    print(json.dumps({"rows": ROWS, "k": K, "device":
                      torch.cuda.get_device_name(0), "median_us": {
                          n: statistics.median(v) for n, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of ``csrc/ssd_chunk.cu`` goes: device µs of the kernel at
the serving shape (4 x 512 tokens, 112 heads x 64, state 64, bf16 B / C)
and of copies of its source with one part cut out.  The cut copies give
wrong outputs; only their times are read.  A cut also removes what only
fed the part (the compiler drops dead code), as each variant's note says.

    python3 tools/ssd_ablate.py [--rounds N]

Builds every variant with ``nvcc`` at once into the git-ignored
``build/tools/ssd_ablate/``, loads each with ``ctypes`` (the kernel's own
C interface) and times them in turns, ``--rounds`` times, from CUDA
events over inputs that exceed L2.  Prints one ``[ablate]`` line a
variant and round, then a JSON line of the medians.
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
OUT = ROOT / "build" / "tools" / "ssd_ablate"
SHAPE = (4, 512, 112, 64, 64)


def _cheap3(x0, x1, o1, o2, o3):
    """split3 replaced by one integer op (keeps its inputs live)."""
    return (f"{o1} = {o2} = {o3} = __float_as_uint({x0}) ^ "
            f"__float_as_uint({x1});")


# name -> (note, [(text in the source, replacement)])
VARIANTS = {
    "full": ("the kernel as it is", []),
    "no M xh": ("the six M xh products, and with them M, its decay and "
                "the splits of M and xh", [
                    (f"mma_bf16(ya[f], {a}, {b}[0], {b}[1]);", "")
                    for a, b in (("a3", "b1"), ("a1", "b3"), ("a2", "b2"),
                                 ("a2", "b1"), ("a1", "b2"),
                                 ("a1", "b1"))]),
    "no M xh splits": ("the bf16 splits of M and xh (packed raw)", [
        ("split3(xg[xoff(sa, pc)], xg[xoff(sa + 1, pc)], b1[0], b2[0], "
         "b3[0]);", _cheap3("xg[xoff(sa, pc)]", "xg[xoff(sa + 1, pc)]",
                            "b1[0]", "b2[0]", "b3[0]")),
        ("split3(xg[xoff(sa + 8, pc)], xg[xoff(sa + 9, pc)], b1[1], b2[1],\n"
         "               b3[1]);",
         _cheap3("xg[xoff(sa + 8, pc)]", "xg[xoff(sa + 9, pc)]", "b1[1]",
                 "b2[1]", "b3[1]"))] + [
        (f"split3(m[{j}][{k}], m[{j}][{k + 1}], a1[{i}], a2[{i}], a3[{i}]);",
         _cheap3(f"m[{j}][{k}]", f"m[{j}][{k + 1}]", f"a1[{i}]", f"a2[{i}]",
                 f"a3[{i}]"))
        for i, (j, k) in enumerate(((0, 0), (0, 2), (1, 0), (1, 2)))]),
    "no decay exp": ("__expf of M's decay (an FMA in its place)",
                     [("__expf(", "(1.0f + 0.0f * ")]),
    "no C h^T splits": ("the bf16 splits of the state for C h^T", [
        ("split2(st[2 * kn][2 * f], st[2 * kn][2 * f + 1], bh0, bl0);",
         "bh0 = bl0 = __float_as_uint(st[2 * kn][2 * f]) ^ "
         "__float_as_uint(st[2 * kn][2 * f + 1]);"),
        ("split2(st[2 * kn + 1][2 * f], st[2 * kn + 1][2 * f + 1], bh1, "
         "bl1);",
         "bh1 = bl1 = __float_as_uint(st[2 * kn + 1][2 * f]) ^ "
         "__float_as_uint(st[2 * kn + 1][2 * f + 1]);")]),
    "no state products": ("the state update's products, and its A operand",
                          [("for (int np = 0; np < kNt / 2; ++np) {",
                            "for (int np = 0; np < 0; ++np) {")]),
    "only loads": ("the 16-row blocks and the cumsum's adds: the copies, "
                   "the barrier and the exps of la remain", [
                       ("for (int g = 0; g < 4; ++g) {",
                        "for (int g = 0; g < 0; ++g) {"),
                       ("acc = (t16 == 0 && u == 0) ? v[0] : acc + v[u];",
                        "acc = v[u];")]),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_ablate.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    source = (build.CSRC / "ssd_chunk.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer "
                                   f"has {old!r}")
            text = text.replace(old, new)
        stem = OUT / name.replace(" ", "_").replace("^", "")
        stem.with_suffix(".cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]),
            stem)
    libs = {}
    for name, (proc, stem) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}")
        lib = ctypes.CDLL(str(stem.with_suffix(".so")))
        lib.ssd_chunk.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                  + [ctypes.c_longlong] * 2
                                  + [ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, s, h, p, n = SHAPE
    first = cs._ssd_inputs(torch, gen, SHAPE, "bf16")
    moved = sum(t.nbytes for t in first) + first[0].nbytes + first[4].nbytes
    sets = [first] + [cs._ssd_inputs(torch, gen, SHAPE, "bf16")
                      for _ in range(-(-cs.L2_FLUSH_BYTES // moved))]
    for args_ in sets:
        args_ += [torch.empty_like(args_[0]), torch.empty_like(args_[4])]

    def call(lib, xh, bm, cm, dla, h0, y, hf):
        err = lib.ssd_chunk(xh.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                            dla.data_ptr(), h0.data_ptr(), y.data_ptr(),
                            hf.data_ptr(), b, s, h, p, n, bm.stride(0),
                            bm.stride(1), 1,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    times = {name: [] for name in VARIANTS}
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            us = 1e3 * cs.device_time_ms(
                lambda *a, lib=lib: call(lib, *a), sets, 10, 5)
            times[name].append(us)
            print(f"[ablate] round {rnd} {name}: {us:.3f} us "
                  f"({VARIANTS[name][0]})")
    print(json.dumps({"shape": SHAPE, "device": torch.cuda.get_device_name(0),
                      "median_us": {k: statistics.median(v)
                                    for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of ``qsgd_pack`` (``csrc/wire_pack.cu``) goes: device µs
of the kernel on the MLP's 280 codec rows and on 8,192 rows (7 levels
unless ``--levels`` names others; Gaussian windows, U[0, 1) noise) and of
copies of its source with a part cut out or a route forced.  The cut
copies give wrong outputs; only their times are read.

    python3 tools/qsgd_pack_ablate.py [--src SRC] [--label LABEL] [--rounds N]
                                      [--levels L,...] [--rows N,...]

SRC is the ``src`` directory of a checkout (default: this checkout's), so
the kernel of two commits can be split on one card in one call: the cuts
are found in either form of the kernel, the one-barrier norm with words
built in registers and the earlier halving tree with a barrier a level and
words built from shared fields.  The variants:

- full: the kernel as it is;
- no norm tree: each thread's own partial taken as the sum of squares
  (no barrier, no cross-thread sum);
- no quantize: each field from ``x + u * norm`` (no division, no floor);
- no word build: words from the fields without shifts (the register form)
  or one field pair a thread stored directly (the shared form: no field
  barrier, no gather loop);
- floor: all three cut, the launch, loads and stores left;
- shared fields (the register form only): every field width through the
  shared-fields route, the words built in registers nowhere; the same
  outputs as full, so the two time the routes against each other.

Builds every variant with ``nvcc`` at once into the git-ignored
``build/tools/qsgd_pack_ablate/``, loads each with ``ctypes`` (the
kernel's own C interface) and times them in turns, ``--rounds`` times,
from CUDA events over inputs that exceed L2.  Prints one ``[ablate]`` line
a variant, size and round, then a JSON line of the medians.
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
OUT = ROOT / "build" / "tools" / "qsgd_pack_ablate"

QUANT = """    const float y = __fmul_rn(__fdiv_rn(fabsf(x[j]), norm), lv);
    const float lo = floorf(y);
    const float code = __fadd_rn(lo, u[j] < __fsub_rn(y, lo) ? 1.0f : 0.0f);
"""
NO_QUANT = "    const float code = __fadd_rn(x[j], __fmul_rn(u[j], norm));\n"
# each cut: (text it starts with, text it ends with, replacement); the
# one-barrier form first, then the earlier form
NORM = (("  part[t] = s;\n  __syncthreads();\n  // levels 128",
         "  sum = __shfl_sync(kFull, sum, 0);\n", "  float sum = s;\n"),
        ("  part[t] = s;\n  __syncthreads();\n  for (int half",
         "__fsqrt_rn(part[0]), (float)1e-30);\n",
         "  const float norm = __fadd_rn(__fsqrt_rn(s), (float)1e-30);\n"))
BUILD = (("      for (int e = 0; e < EPW; ++e) wd[k] |= ",
          "f[k * EPW + e] << (bits * e);\n",
          "      for (int e = 0; e < EPW; ++e) wd[k] ^= f[k * EPW + e];\n"),
         ("  __syncthreads();\n  for (int i = t; i < nwords;",
          "    words_out[w * nwords + i] = word;\n  }\n",
          "  words_out[w * nwords + t] = field[8 * t] ^ field[8 * t + 7];\n"))
# the register routes turned off: every epw takes the shared fields
SHARED = (("  if constexpr (EPW == 8 || EPW == 4 || EPW == 2) {",
           "  if constexpr (false) {"),
          ("  } else if constexpr (EPW == 16) {",
           "  } else if constexpr (false) {"))
VARIANTS = {"full": (), "no norm tree": ("norm",),
            "no quantize": ("quant",), "no word build": ("build",),
            "floor": ("norm", "quant", "build"), "shared fields": ("shared",)}


def _cut(text: str, forms) -> str:
    """Replace the first form of a cut found in ``text``."""
    for start, end, new in forms:
        i = text.find(start)
        if i < 0:
            continue
        j = text.index(end, i) + len(end)
        return text[:i] + new + text[j:]
    raise RuntimeError(f"cut not found: {forms[0][0]!r}")


def _build(build, csrc: Path, label: str):
    procs = {}
    source = (csrc / "wire_pack.cu").read_text()
    for i, (name, cuts) in enumerate(VARIANTS.items()):
        text = source
        if "shared" in cuts:
            if not all(old in text for old, _ in SHARED):
                continue            # the earlier form has one route
            for old, new in SHARED:
                text = text.replace(old, new)
        if "norm" in cuts:
            text = _cut(text, NORM)
        if "quant" in cuts:
            if QUANT not in text:
                raise RuntimeError("cut not found: the quantization")
            text = text.replace(QUANT, NO_QUANT)
        if "build" in cuts:
            text = _cut(text, BUILD)
        out = OUT / label.replace(" ", "_") / f"v{i}"
        out.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (out / header.name).write_text(header.read_text())
        (out / "wire_pack.cu").write_text(text)
        lib = out / "libqsgd.so"
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
        so.qsgd_pack.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                                 + [ctypes.c_int] * 4
                                 + [ctypes.c_float, ctypes.c_void_p])
        so.qsgd_pack.restype = ctypes.c_int
        libs[name] = so
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--levels", default="7")
    ap.add_argument("--rows", default="280,8192")
    args = ap.parse_args(argv)
    levels_list = [int(v) for v in args.levels.split(",")]
    rows_list = [int(v) for v in args.rows.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("qsgd_pack_ablate.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import wire_formats as WF
    from repro_torch.kernels import build
    libs = _build(build, src / "repro_torch" / "csrc", args.label)
    gen = torch.Generator(device="cuda").manual_seed(7)
    times = {f"{n} {r} L{lv}": [] for n in libs for r in rows_list
             for lv in levels_list}
    for rows, levels in ((r, lv) for r in rows_list for lv in levels_list):
        bits, epw = WF.qsgd_bits(levels), WF.qsgd_elems_per_word(levels)
        nwords = WF.qsgd_words_per_window(levels)
        denom = WF.qsgd_scale_denominator(levels)
        n_sets = -(-cs.L2_FLUSH_BYTES // (2 * rows * cs.PACK_BLOCK * 4)) + 1
        sets = []
        for _ in range(n_sets):
            x = torch.randn(rows, cs.PACK_BLOCK, generator=gen, device="cuda")
            sets.append([x, torch.rand(x.shape, generator=gen,
                                       device="cuda")])
        words = torch.empty(rows, nwords, dtype=torch.int32, device="cuda")
        scale = torch.empty(rows, 1, device="cuda")
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                def call(x, u, lib=lib):
                    err = lib.qsgd_pack(
                        x.data_ptr(), u.data_ptr(), words.data_ptr(),
                        scale.data_ptr(), rows, levels, bits, epw, nwords,
                        denom, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"qsgd_pack launch failed: {err}")
                us = 1e3 * cs.device_time_ms(call, sets, 20, 10)
                times[f"{name} {rows} L{levels}"].append(us)
                print(f"[ablate] {args.label} round {rnd} {name} rows={rows} "
                      f"levels={levels}: {us:.3f} us")
        if "shared fields" in libs:    # the two routes' words agree
            got = {}
            for name in ("full", "shared fields"):
                libs[name].qsgd_pack(
                    sets[0][0].data_ptr(), sets[0][1].data_ptr(),
                    words.data_ptr(), scale.data_ptr(), rows, levels, bits,
                    epw, nwords, denom,
                    torch.cuda.current_stream().cuda_stream)
                got[name] = (words.clone(), scale.clone())
            same = all(torch.equal(a, b) for a, b in
                       zip(got["full"], got["shared fields"]))
            print(f"[ablate] {args.label} rows={rows} levels={levels}: "
                  f"shared fields equal full: {same}")
            if not same:
                raise AssertionError("the routes' words differ")
        del sets
    print(json.dumps({"label": args.label, "device":
                      torch.cuda.get_device_name(0), "median_us": {
                          n: statistics.median(v) for n, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

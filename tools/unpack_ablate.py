"""How far above their floor the two wire unpacks (``csrc/wire_pack.cu``)
sit: device µs of ``qsgd_unpack`` and ``topk_unpack`` on the MLP's 280 codec
rows and on 8,192 rows, beside a floor kernel with the same grid (one CTA
of 256 threads a window) that only stores the window's zeros, two 16-byte
stores a thread: float4 t and t + 256 (``coalesced``) or 2t and 2t + 1
(``pairs``, ``qsgd_unpack``'s elements 8t ... 8t + 7).  The operands are
the plain pack's buffers of Gaussian windows.

    python3 tools/unpack_ablate.py [--src SRC] [--label LABEL] [--rounds N]
                                   [--levels L,...] [--k K,...] [--rows N,...]

SRC is the ``src`` directory of a checkout (default: this checkout's).  The
variants, each a copy of the tree's ``wire_pack.cu``:

- full: the kernels as they are, and the floor kernel appended;
- no order check (where ``topk_unpack`` has one): its
  ``__syncthreads_or`` over "an index is not above the previous slot's"
  replaced by a plain barrier, and the previous index's load and shuffle
  cut, so it always takes the fast path; the same outputs on the windows
  timed here, so the two time the check.

Builds every variant with ``nvcc`` at once into the git-ignored
``build/tools/unpack_ablate/``, loads each with ``ctypes`` and times them
in turns, ``--rounds`` times, from CUDA events over inputs that exceed L2.
Prints one ``[ablate]`` line a cell and round, then a JSON line of the
medians.
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
OUT = ROOT / "build" / "tools" / "unpack_ablate"

FLOOR = """
namespace {
// thread t stores float4 t and t + 256 (pairs 0: one coalesced 512 B run a
// warp and store) or 2t and 2t + 1 (pairs 1: qsgd_unpack's 8t ... 8t + 7)
__global__ void __launch_bounds__(256) unpack_floor_kernel(float* out,
                                                           int pairs) {
  float4* dst = reinterpret_cast<float4*>(out + (int64_t)blockIdx.x * 2048);
  const int t = threadIdx.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  dst[pairs ? 2 * t : t] = zero;
  dst[pairs ? 2 * t + 1 : t + 256] = zero;
}
}  // namespace

extern "C" int unpack_floor(void* out, int64_t nb, int pairs, void* stream) {
  unpack_floor_kernel<<<(unsigned)nb, 256, 0, (cudaStream_t)stream>>>(
      (float*)out, pairs);
  return (int)cudaGetLastError();
}
"""
# the order check cut: (text it starts with, text it ends with,
# replacement)
NO_CHECK = (("      // slot r - 1 is the lane below's",
             "prev[i] = __ldg(ix + r - 1);\n", ""),
            ("  bool unordered = false;\n",
             "unordered |= prev[i] >= j[i];\n  }\n",
             "  const bool unordered = false;\n"),
            ("  if (!__syncthreads_or(unordered)) {", "{",
             "  __syncthreads();\n  if (!unordered) {"))
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {"qsgd_unpack": [_P, _P, _P, _I64, _I, _I, _I, _P],
              "topk_unpack": [_P, _P, _P, _I64, _I, _P],
              "unpack_floor": [_P, _I64, _I, _P]}


def _build(build, csrc: Path, label: str):
    source = (csrc / "wire_pack.cu").read_text() + FLOOR
    variants = {"full": source}
    if all(start in source for start, _, _ in NO_CHECK):
        text = source
        for start, end, new in NO_CHECK:
            i = text.index(start)
            j = text.index(end, i) + len(end)
            text = text[:i] + new + text[j:]
        variants["no order check"] = text
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        out = OUT / label.replace(" ", "_") / f"v{i}"
        out.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (out / header.name).write_text(header.read_text())
        (out / "wire_pack.cu").write_text(text)
        lib = out / "libunpack.so"
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
        for fn, argtypes in SIGNATURES.items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        libs[name] = so
    return libs


def _checked(err, name):
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--levels", default="7,16")
    ap.add_argument("--k", default="102,512")
    ap.add_argument("--rows", default="280,8192")
    args = ap.parse_args(argv)
    levels_list = [int(v) for v in args.levels.split(",")]
    k_list = [int(v) for v in args.k.split(",")]
    rows_list = [int(v) for v in args.rows.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("unpack_ablate.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import wire_formats as WF
    from repro_torch.kernels import build, ref
    libs = _build(build, src / "repro_torch" / "csrc", args.label)
    gen = torch.Generator(device="cuda").manual_seed(9)
    times = {}
    for rows in rows_list:
        out = torch.empty(rows, cs.PACK_BLOCK, device="cuda")
        cells = ([("floor", 0), ("floor", 1)]
                 + [("qsgd_unpack", lv) for lv in levels_list]
                 + [("topk_unpack", k) for k in k_list])
        for kernel, param in cells:
            def make():
                x = torch.randn(rows, cs.PACK_BLOCK, generator=gen,
                                device="cuda")
                if kernel == "topk_unpack":
                    return list(ref.topk_pack_ref(x, param))
                if kernel == "qsgd_unpack":
                    return list(ref.qsgd_pack_ref(
                        x, torch.rand(x.shape, generator=gen,
                                      device="cuda"), param))
                return []
            first = make()
            moved = sum(t.nbytes for t in first) + out.nbytes
            n_sets = -(-cs.L2_FLUSH_BYTES // moved) + 1
            sets = [first] + [make() for _ in range(n_sets - 1)]
            for rnd in range(args.rounds):
                for name, lib in libs.items():
                    def call(*a, lib=lib):
                        stream = torch.cuda.current_stream().cuda_stream
                        if kernel == "floor":
                            _checked(lib.unpack_floor(out.data_ptr(), rows,
                                                      param, stream), kernel)
                        elif kernel == "topk_unpack":
                            _checked(lib.topk_unpack(
                                a[0].data_ptr(), a[1].data_ptr(),
                                out.data_ptr(), rows, param, stream), kernel)
                        else:
                            _checked(lib.qsgd_unpack(
                                a[0].data_ptr(), a[1].data_ptr(),
                                out.data_ptr(), rows, WF.qsgd_bits(param),
                                WF.qsgd_elems_per_word(param),
                                WF.qsgd_words_per_window(param), stream),
                                kernel)
                    us = 1e3 * cs.device_time_ms(call, sets, 20, 10)
                    tag = {"floor": ("coalesced", "pairs")[param]
                           if kernel == "floor" else "",
                           "topk_unpack": f"k{param}",
                           "qsgd_unpack": f"L{param}"}[kernel]
                    cell = f"{name} {kernel} {tag} {rows}"
                    times.setdefault(cell, []).append(us)
                    print(f"[ablate] {args.label} round {rnd} {cell}: "
                          f"{us:.3f} us")
            del sets, first
    print(json.dumps({"label": args.label, "device":
                      torch.cuda.get_device_name(0), "median_us": {
                          n: statistics.median(v) for n, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

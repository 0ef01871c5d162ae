"""Where ``mean_noise``'s time goes (``csrc/smooth_clip.cu``'s
``mean_noise_kernel``, the DP perturbation of the clipped samples' mean):
device µs of the kernel beside copies with one knob turned or one part cut
out, on PORTER-DP's plane (10 agents x 8 samples x 7 tiles) in f32 and
bf16, DP-SGD's (1 x 8 x 7) and 10 x 32 x 7, f32 unless named.

    python3 tools/mean_noise_ablate.py [--src SRC] [--label LABEL]
                                       [--rounds N]

SRC is the ``src`` directory of a checkout (default: this checkout's).  The
variants, each a copy of the tree's ``smooth_clip.cu`` with one text
replaced:

- full: the kernel as it is;
- batch 4: four samples' loads in flight a thread (``kMeanBatch``), not 8;
- 3 CTAs/SM: ``__launch_bounds__`` asks for three resident CTAs of 256
  threads (at most 85 registers a thread);
- batch 4, 4 CTAs/SM: both, at most 64 registers;
- 128 threads: the largest CTA 128 threads (``kMeanThreads``);
- no samples: the sample loop cut (the noise read and the output written,
  the launch of the same grid: the kernel's floor; timing only).

Builds every variant with ``nvcc -Xptxas -v`` at once into the git-ignored
``build/tools/mean_noise_ablate/``, prints each one's registers, loads each
with ``ctypes`` and times them in turns, ``--rounds`` times, from CUDA
events over operands that exceed L2; each variant but the floor must give
the full kernel's bits.  Prints one ``[ablate]`` line a cell and round,
then a JSON line of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tools" / "mean_noise_ablate"
TILE = 8192
SIGMA = 0.01
# (groups, b, tiles a row, dtype)
CELLS = {"porter-dp f32": (10, 8, 7, "f32"), "porter-dp bf16": (10, 8, 7,
                                                                "bf16"),
         "dp-sgd f32": (1, 8, 7, "f32"), "10 x 32 x 7 f32": (10, 32, 7,
                                                             "f32")}
BATCH = "constexpr int kMeanBatch = 8;"
THREADS = "constexpr int kMeanThreads = 256;"
BOUNDS = "__global__ void __launch_bounds__(kMeanThreads)\nmean_noise_kernel"
LOOP = "for (int s0 = 0; s0 < b; s0 += kBatch)"
VARIANTS = {"full": (),
            "batch 4": ((BATCH, BATCH.replace("8", "4")),),
            "3 CTAs/SM": ((BOUNDS, BOUNDS.replace("(kMeanThreads)",
                                                  "(kMeanThreads, 3)")),),
            "batch 4, 4 CTAs/SM": ((BATCH, BATCH.replace("8", "4")),
                                   (BOUNDS, BOUNDS.replace(
                                       "(kMeanThreads)",
                                       "(kMeanThreads, 4)"))),
            "128 threads": ((THREADS, THREADS.replace("256", "128")),),
            "no samples": ((LOOP, LOOP.replace("s0 < b", "s0 < 0")),)}
# x, bf16, noise, acc, finish, sigma, out, groups, b, b_total, tiles, stream
SIGNATURE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]


def _build(build, csrc: Path, label: str):
    source = (csrc / "smooth_clip.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"smooth_clip.cu has no {old!r} to change")
            text = text.replace(old, new)
        src = OUT / f"{label}_{i}.cu"
        src.write_text(text)
        lib = OUT / f"{label}_{i}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = []
        for entry in log.split("Compiling entry function")[1:]:
            head = entry.split("\n")[0]
            if "mean_noise_kernel" in head:
                used = re.search(r"Used (\d+) registers", entry)
                spill = re.search(r"(\d+) bytes spill stores", entry)
                regs.append(f"{'bf16' if 'bfloat16' in head else 'f32'} "
                            f"{used and used.group(1)} registers, "
                            f"{spill and spill.group(1)} B spilled")
        print(f"[ablate] {label} {name}: mean_noise_kernel "
              + "; ".join(regs))
        lib = ctypes.CDLL(str(lib))
        lib.clip_mean_noise.argtypes = SIGNATURE
        lib.clip_mean_noise.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mean_noise_ablate.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    libs = _build(build, src / "repro_torch" / "csrc",
                  args.label.replace(" ", "_"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    table = {}
    for cell, (groups, b, tiles, dt) in CELLS.items():
        dtype = torch.float32 if dt == "f32" else torch.bfloat16

        def make():
            return [torch.randn(groups * b * tiles, TILE, generator=gen,
                                device="cuda").to(dtype),
                    torch.randn(groups * tiles, TILE, generator=gen,
                                device="cuda"),
                    torch.empty(groups * tiles, TILE, device="cuda")]
        first = make()
        moved = first[0].nbytes + 2 * first[1].nbytes
        sets = [first] + [make() for _ in range(
            -(-cs.L2_FLUSH_BYTES // moved))]

        def call(lib):
            def run(x, z, out):
                err = lib.clip_mean_noise(x.data_ptr(), int(dt == "bf16"),
                                          z.data_ptr(), None, 1, SIGMA,
                                          out.data_ptr(), groups, b, b, tiles,
                                          stream)
                if err:
                    raise RuntimeError(f"clip_mean_noise failed: {err}")
            return run
        outs = {}
        for name, lib in libs.items():
            call(lib)(*first)
            torch.cuda.synchronize()
            outs[name] = first[2].clone()
        for name in libs:
            if name != "no samples" and not torch.equal(
                    outs[name].view(torch.int32),
                    outs["full"].view(torch.int32)):
                raise AssertionError(f"{name} differs from full at {cell}")
        for r in range(args.rounds):
            for name, lib in libs.items():
                us = 1e3 * cs.device_time_ms(call(lib), sets, 20, 10)
                table.setdefault(cell, {}).setdefault(name, []).append(us)
                bound = 1e6 * moved / cs.HBM_BYTES_PER_S
                print(f"[ablate] {args.label} {cell} round {r} {name}: "
                      f"{us:.3f} us (bound {bound:.3f})")
        del sets, first
    print(json.dumps({"label": args.label, "us": {
        cell: {name: statistics.median(v) for name, v in row.items()}
        for cell, row in table.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

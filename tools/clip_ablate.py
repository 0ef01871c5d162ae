"""Where the fused smooth clip's time goes (``csrc/smooth_clip.cu``'s
``clip_cluster_kernel`` and ``clip_kernel``): device µs of the kernel
beside copies with one part cut out and beside floor kernels of the same
launch shape, on the MLP's agent plane (10 rows x 7 tiles), PORTER-DP's
per-sample plane (80 x 7), the DP perturbation's plane as one clipped row
(1 x 63) and 2^24 elements (1 row), f32.

    python3 tools/clip_ablate.py [--src SRC] [--label LABEL] [--rounds N]
                                 [--planes mlp,dp,dp-noise,2^24]

SRC is the ``src`` directory of a checkout (default: this checkout's).  The
variants, each a copy of the tree's ``smooth_clip.cu``:

- full: the kernel as it is (rows of at most 8 tiles take the cluster
  route, longer ones the cooperative launch);
- cooperative: every row through the cooperative launch (``kMaxCluster``
  set to 0);
- cooperative, no grid sync: the same with the grid-wide barrier replaced
  by a CTA barrier (the factors then read partials that may not be
  written yet: timing only);

and floor kernels appended to the full copy, launched with each route's
grid and block (``clip_plan``) and its shared memory: ``empty`` (returns
at once) with a plain and with a cooperative launch, ``grid sync`` (one
grid-wide barrier, cooperative) and ``cluster sync`` (one cluster barrier,
a cluster a row, where the plan is the cluster route).

Builds every variant with ``nvcc`` at once into the git-ignored
``build/tools/clip_ablate/``, loads each with ``ctypes`` and times them in
turns, ``--rounds`` times, from CUDA events over operands that exceed L2.
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
OUT = ROOT / "build" / "tools" / "clip_ablate"
TILE = 8192
PLANES = {"mlp": (10, 7), "dp": (80, 7), "dp-noise": (1, 63),
          "2^24": (1, 2048)}

FLOOR = """
namespace {
__global__ void clip_floor_kernel(int mode) {
  if (mode == 2) cooperative_groups::this_grid().sync();
  if (mode == 3) cooperative_groups::this_cluster().sync();
}
}  // namespace

// mode 0: empty, plain launch; 1: empty, cooperative; 2: one grid-wide
// barrier, cooperative; 3: one cluster barrier, clusters of `cluster`
extern "C" int clip_floor(int mode, int64_t grid, int64_t smem,
                          int64_t cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kClipThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (mode == 3) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = mode > 0;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, clip_floor_kernel, mode);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""
SYNC = "  cooperative_groups::this_grid().sync();\n"
CLUSTER = "constexpr int kMaxCluster = 8;"
# each route's shared memory a CTA, f32: the cluster kernel's staged tile,
# 512 partials and two floats; the cooperative kernel's two sets of 512
# partials and 16 factors
SMEM = {1: 4 * TILE + 4 * 512 + 8, 0: 4 * (2 * 512 + 16)}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {"clip_fused": [_P, _I, _P, ctypes.c_float, ctypes.c_float, _P,
                             _P, _P, _I64, _I64, _P],
              "clip_plan": [_I, _I, _I64, _I64, _P],
              "clip_floor": [_I, _I64, _I64, _I64, _P]}


def _build(build, csrc: Path, label: str):
    source = (csrc / "smooth_clip.cu").read_text()
    if SYNC not in source or CLUSTER not in source:
        raise SystemExit("smooth_clip.cu has no grid barrier or cluster "
                         "route to cut")
    coop = source.replace(CLUSTER, "constexpr int kMaxCluster = 0;")
    variants = {"full": source + FLOOR, "cooperative": coop,
                "cooperative, no grid sync": coop.replace(
                    SYNC, "  __syncthreads();\n")}
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        src = OUT / f"{label}_{i}.cu"
        src.write_text(text)
        lib = OUT / f"{label}_{i}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in SIGNATURES.items():
            if fn == "clip_floor" and name != "full":
                continue
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def _time(torch, call, reps=20, inner=10):
    """Median µs of one call over ``inner`` back-to-back calls behind a
    sleep, from CUDA events."""
    call(0)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for i in range(inner):
            call(i)
        end.record()
        end.synchronize()
        samples.append(1e3 * start.elapsed_time(end) / inner)
    return statistics.median(samples)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--planes", default=",".join(PLANES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("clip_ablate.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    libs = _build(build, Path(args.src) / "repro_torch" / "csrc", args.label)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for plane in args.planes.split(","):
        rows, tiles = PLANES[plane]
        n = rows * tiles
        sets = max(2, -(-(100 << 20) // (8 * n * TILE)) + 1)
        xs = [torch.randn(n, TILE, generator=gen, device="cuda")
              for _ in range(sets)]
        outs = [torch.empty_like(x) for x in xs]
        part = torch.empty(n, device="cuda")
        fac = torch.empty(rows, device="cuda")
        plans = {}
        for name in ("full", "cooperative"):
            plan = (ctypes.c_int64 * 3)()
            err = libs[name].clip_plan(0, 0, n, tiles, plan)
            if err:
                raise SystemExit(f"clip_plan failed: {err}")
            plans[name] = tuple(plan)

        def kernel(lib):
            def call(i):
                err = lib.clip_fused(xs[i % sets].data_ptr(), 0, None, 0.0,
                                     1.0, outs[i % sets].data_ptr(),
                                     part.data_ptr(), fac.data_ptr(), n,
                                     tiles, stream)
                if err:
                    raise SystemExit(f"clip_fused failed: {err}")
            return call

        def floor(mode):
            # the cluster floor takes the full plan's shape, the others
            # the cooperative launch's
            route, grid, _ = plans["full" if mode == 3 else "cooperative"]
            smem = SMEM[route]

            def call(i):
                err = libs["full"].clip_floor(mode, grid, smem, tiles,
                                              stream)
                if err:
                    raise SystemExit(f"clip_floor failed: {err}")
            return call

        cells = {name: kernel(lib) for name, lib in libs.items()}
        cells["floor: empty, plain launch"] = floor(0)
        cells["floor: empty, cooperative"] = floor(1)
        cells["floor: one grid sync, cooperative"] = floor(2)
        if plans["full"][0] == 1:
            cells["floor: one cluster sync, a cluster a row"] = floor(3)
        for r in range(args.rounds):
            for name, call in cells.items():
                us = _time(torch, call)
                results.setdefault(f"{plane} {name}", []).append(us)
                print(f"[ablate] {args.label} {plane} rows={rows} "
                      f"tiles/row={tiles} plans (cluster, grid, tiles/cta)="
                      f"{plans} round={r} {name}: {us:.3f} us")
        del xs, outs
    print(json.dumps({"label": args.label, "gpu": smi, "median_us": {
        k: statistics.median(v) for k, v in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

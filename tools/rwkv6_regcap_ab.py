"""A/B of the ``rwkv6_chunk`` kernel's register cap, in one process on one
card: the source as committed (``__launch_bounds__(kThreads, kMinCtas)``)
against the same source without the minimum-CTAs argument.

Both are compiled with the port's nvcc flags plus ``-Xptxas -v`` (whose
register and spill lines are printed), then timed with CUDA events over
cold operands in the order capped, uncapped, uncapped, capped at the
serving path's scan shape (4, 512, 64, 64) and at (2, 4096, 64, 64), bf16
r, k, v.  Prints one line per build and shape, and the two outputs' largest
difference.  Run from the repo root on a machine with the card:

    python3 tools/rwkv6_regcap_ab.py
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"path": (4, 512, 64, 64), "2x4096": (2, 4096, 64, 64)}
CAP = "__launch_bounds__(kThreads, kMinCtas)"


def _build(build, src: str, name: str):
    out_dir = build.BUILD_DIR / "regcap_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{name}.so"
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", str(lib), str(cu)],
                         capture_output=True, text=True, check=True)
    for line in (log.stdout + log.stderr).splitlines():
        if any(w in line for w in ("entry function", "Used", "spill")):
            print(f"[regcap] {name} ptxas: {line.strip()}")
    so = ctypes.CDLL(str(lib))
    so.rwkv6_chunk.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    so.rwkv6_chunk.restype = ctypes.c_int
    return so


def _call(torch, so, r, k, v, logw, u, s0, o, s_fin):
    b, s, h, n = r.shape
    err = so.rwkv6_chunk(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                         logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
                         o.data_ptr(), s_fin.data_ptr(), b, s, h, n, 1,
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_chunk failed with CUDA error {err}")


def _time_us(torch, so, sets, reps=10, inner=5):
    for args in sets:
        _call(torch, so, *args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for i in range(inner):
            _call(torch, so, *sets[i % len(sets)])
        end.record()
        end.synchronize()
        samples.append(1e3 * start.elapsed_time(end) / inner)
    return statistics.median(samples)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rwkv6_regcap_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    src = (build.CSRC / "rwkv6_chunk.cu").read_text()
    if src.count(CAP) != 1:
        raise RuntimeError(f"rwkv6_chunk.cu no longer holds {CAP}")
    uncapped = src.replace(CAP, "__launch_bounds__(kThreads)")
    libs = {"capped": _build(build, src, "capped"),
            "uncapped": _build(build, uncapped, "uncapped")}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, shape in SHAPES.items():
        b, s, h, n = shape
        sets = []
        for _ in range(4):        # 63-126 MB a set: four pass the 50 MB L2
            r, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            logw = -(0.01 + 4.89 * torch.rand(shape, generator=gen,
                                              device="cuda"))
            u = torch.randn(h, n, generator=gen, device="cuda")
            s0 = torch.randn(b, h, n, n, generator=gen, device="cuda")
            sets.append((r, k, v, logw, u, s0, torch.empty_like(logw),
                         torch.empty_like(s0)))
        times = {name: [] for name in libs}
        for name in ("capped", "uncapped", "uncapped", "capped"):
            times[name].append(_time_us(torch, libs[name], sets))
        outs = {}
        for name, so in libs.items():
            args = sets[0][:6]
            o, s_fin = torch.empty_like(args[3]), torch.empty_like(args[5])
            _call(torch, so, *args, o, s_fin)
            outs[name] = (o, s_fin)
        torch.cuda.synchronize()
        diff = max(float((a - b_).abs().max())
                   for a, b_ in zip(outs["capped"], outs["uncapped"]))
        for name, ts in times.items():
            print(f"[regcap] {label} {shape} {name}: us {ts} (mean "
                  f"{statistics.mean(ts):.3f})")
        ratio = (statistics.mean(times["capped"])
                 / statistics.mean(times["uncapped"]))
        print(f"[regcap] {label}: capped / uncapped {ratio:.4f}, max "
              f"|capped - uncapped| {diff}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

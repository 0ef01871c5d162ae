#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  It imports nothing of JAX or
of the ``repro`` package.  Phases, each printing its own line:

0. device: the card's name and power limit (``nvidia-smi``), versions, TF32.
1. build: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` into
   ``build/kernels/``.
2. kernels: ``ef_track`` / ``ef_step`` against their plain PyTorch versions
   on the card, bitwise, at the main-path plane sizes and at 2^24 elements,
   timed with CUDA events beside their bandwidth bound.
3. the Section-5.1 quickstart (PORTER-GC, logistic regression, 10 agents,
   ER(0.8), top-k 5 %) for 400 rounds through ``build`` + ``run_chunked``:
   the ``gn < 0.1`` gate, and 400 launches of each kernel.
4. the Section-5.2 MLP at full width (784 -> 64 -> 10): PORTER-GC for 200
   rounds on the kernel and on the ref backend from one seed (they must
   agree), then PORTER-DP for 50 rounds.

Any failure raises and exits non-zero.  The line before the last is the
kernels' JSON record; the last line is the device record.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TILE = 8 * 1024
PLANES = {"mlp": 10 * 7 * TILE,      # Section-5.2 MLP: d=50,890 -> 7 tiles
          "logreg": 10 * 1 * TILE,   # Section-5.1 logreg: d=124 -> 1 tile
          "2^24": 1 << 24}
MAIN_PLANE = "mlp"
KERNELS = {
    # operands read, outputs written, f32 operations per element
    "ef_track": dict(reads=7, writes=3, ops=7,
                     replaces="src/repro/kernels/ef_update.py:69"),
    "ef_step": dict(reads=6, writes=3, ops=6,
                    replaces="src/repro/kernels/ef_update.py:96"),
}
GAMMA, ETA = 0.0142897, 0.05
# bytes of operands rotated through per timing, twice the H100's 50 MB L2
L2_FLUSH_BYTES = 100 * 2**20


def logreg_loss(params, batch):
    """Section 5.1: logistic loss plus the nonconvex regularizer."""
    import torch
    f, labels = batch
    f, labels = torch.atleast_2d(f), torch.atleast_1d(labels)
    logits = f @ params["w"] + params["b"]
    nll = torch.mean(torch.log1p(torch.exp(-(2 * labels - 1) * logits)))
    return nll + 0.2 * torch.sum(params["w"] ** 2 / (1 + params["w"] ** 2))


def grad_norm(loss_fn, params, batch) -> float:
    import torch
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(loss_fn(leaves, batch), list(leaves.values()))
    return float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))


def device_time_ms(fn, arg_sets, reps: int = 50, inner: int = 20) -> float:
    """Median device time of one call, from CUDA events around ``inner``
    back-to-back calls that rotate through ``arg_sets``.  A sleep kernel
    queued first keeps the card busy while the host enqueues the calls, so
    the events bracket device work and not the host's launch rate."""
    import torch
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for i in range(inner):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound_ms(name: str, n: int):
    """Least time for the card: bytes over HBM bandwidth vs operations over
    the f32 rate; returns (ms, 'bytes' | 'operations')."""
    k = KERNELS[name]
    t_bytes = (k["reads"] + k["writes"]) * 4 * n / HBM_BYTES_PER_S
    t_ops = k["ops"] * n / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, ops, ref):
    """Each kernel against its plain version at every plane size.

    ``ms`` is timed cold: the calls rotate through enough operand sets that
    each call's bytes come from device memory, not from the 50 MB L2 (what
    the HBM bound assumes); ``ms_warm`` repeats one set, whose operands stay
    in L2 when they fit.
    """
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = {"ef_track": (lambda *a: ops.ef_track(*a, GAMMA),
                        lambda *a: ref.ef_track_ref(*a, GAMMA)),
           "ef_step": (lambda *a: ops.ef_step(*a, GAMMA, ETA),
                       lambda *a: ref.ef_step_ref(*a, GAMMA, ETA))}
    table = {}
    for size_name, n in PLANES.items():
        for name, (kern, plain) in fns.items():
            k = KERNELS[name]
            per_call = (k["reads"] + k["writes"]) * 4 * n
            n_sets = -(-L2_FLUSH_BYTES // per_call) + 1
            sets = [[torch.randn(n // TILE, TILE, generator=gen,
                                 device="cuda") for _ in range(k["reads"])]
                    for _ in range(n_sets)]
            k_out, p_out = kern(*sets[0]), plain(*sets[0])
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
            err = max(float((a - b).abs().max()) for a, b in zip(k_out, p_out))
            row = dict(elements=n, equal=equal, max_abs_err=err,
                       ms=device_time_ms(kern, sets),
                       ms_warm=device_time_ms(kern, sets[:1]),
                       plain_ms=device_time_ms(plain, sets),
                       plain_ms_warm=device_time_ms(plain, sets[:1]))
            row["bound_ms"], row["bound_by"] = bound_ms(name, n)
            table[(name, size_name)] = row
            print(f"[kernels] {name} {size_name} n={n} bitwise={equal} "
                  f"max_abs_err={err} ms={row['ms']} "
                  f"ms_warm={row['ms_warm']} plain_ms={row['plain_ms']} "
                  f"plain_ms_warm={row['plain_ms_warm']} "
                  f"bound_ms={row['bound_ms']} ({row['bound_by']})")
            if not equal:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {size_name}: max |diff| {err}")
            del sets, k_out, p_out
    return table


def run_timed(torch, run_chunked, algo, source, state, seed, steps, chunk):
    """Run ``steps`` rounds; returns (state, per-round losses, ms/round).

    ms/round is the steady state: host wall time from the end of the first
    chunk to the end of the last, each chunk ended by a synchronize, so
    one-time set-up (library handles, first launches) stays out of it.
    """
    losses, stamps = [], []

    def keep(t0, t1, st, metrics):
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        stamps.append((t1, time.perf_counter()))

    torch.cuda.synchronize()
    state, _ = run_chunked(algo, source, state, seed, steps, chunk=chunk,
                           on_chunk=keep)
    (r0, w0), (r1, w1) = stamps[0], stamps[-1]
    return state, torch.cat(losses).tolist(), 1e3 * (w1 - w0) / (r1 - r0)


def profile_rounds(torch, runtime, algo, source, state, rounds, label):
    """Device busy share and kernel breakdown of ``rounds`` rounds, under
    ``torch.profiler`` (which itself slows the host side)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    runtime.run_chunked(algo, source, state, 0, 2, chunk=2)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runtime.run_chunked(algo, source, state, 0, rounds, chunk=rounds)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        print(f"[profile] {label}: device time not measured (the profiler "
              "recorded no CUDA kernels)")
        return
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[profile] {label}: {rounds} rounds, wall {wall_us / rounds:.1f} "
          f"us/round, device busy {busy_us / rounds:.1f} us/round "
          f"({100 * busy_us / wall_us:.2f} %), {launches / rounds:.1f} "
          "kernel launches/round; top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / rounds:.1f} us "
              f"x{e.count / rounds:.1f}" for e in top))


def phase_quickstart(torch, ops, api, data, runtime, average_params):
    """Section-5.1 protocol, as examples/quickstart.py runs it."""
    x, y = data.a9a_like(num=20000, dim=123, seed=0)
    xs, ys = data.shard_to_agents(x, y, 10)
    source = data.minibatch_source(xs, ys, batch=8)
    spec = api.ExperimentSpec(algo="porter-gc", n_agents=10,
                              topology="erdos_renyi",
                              topology_weights="best_constant",
                              topology_p=0.8, topology_seed=1,
                              compressor="top_k", frac=0.05, eta=0.05,
                              tau=1.0)
    algo = api.build(spec, logreg_loss)
    state = algo.init({"w": torch.zeros(123), "b": torch.zeros(())})
    ops.reset_launches()
    state, losses, ms = run_timed(torch, runtime.run_chunked, algo, source,
                                  state, 0, 400, 50)
    launches = dict(ops.LAUNCHES)
    full = (torch.as_tensor(xs.reshape(-1, 123), device="cuda"),
            torch.as_tensor(ys.reshape(-1), device="cuda"))
    gn = grad_norm(logreg_loss, average_params(state.x), full)
    print(f"[quickstart] porter-gc 400 rounds: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, gn {gn:.6f}, {ms:.4f} ms/round, "
          f"launches {launches}")
    if not gn < 0.1:
        raise AssertionError(f"quickstart gate failed: gn = {gn}")
    if launches != {"ef_track": 400, "ef_step": 400}:
        raise AssertionError(f"expected 400 launches of each kernel, got "
                             f"{launches}")
    profile_rounds(torch, runtime, algo, source, state, 20, "quickstart")


def phase_mlp(torch, ops, api, data, runtime, paper, num=60000, rounds=200,
              dp_rounds=50):
    """Section-5.2 MLP at full width: kernel vs ref backend, then DP."""
    x, y = data.mnist_like(num=num, seed=0)
    xs, ys = data.shard_to_agents(x, y, 10)
    source = data.minibatch_source(xs, ys, batch=8)
    base = api.ExperimentSpec(algo="porter-gc", n_agents=10,
                              topology="erdos_renyi",
                              topology_weights="best_constant",
                              topology_p=0.8, topology_seed=1,
                              compressor="top_k", frac=0.05, eta=0.2,
                              tau=1.0)
    loss_fn = paper.mlp_loss()
    out = {}
    for backend in ("kernel", "ref"):
        algo = api.build(base.replace(comm_backend=backend), loss_fn)
        state = algo.init(paper.mlp_init(seed=0))
        ops.reset_launches()
        state, losses, ms = run_timed(torch, runtime.run_chunked, algo,
                                      source, state, 0, rounds, 50)
        out[backend] = (state, losses, ms, dict(ops.LAUNCHES))
        print(f"[mlp] porter-gc {backend} {rounds} rounds: loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}, {ms:.4f} ms/round, "
              f"launches {out[backend][3]}")
    (s_k, l_k, _, n_k), (s_r, _, _, n_r) = out["kernel"], out["ref"]
    diff = max(float((s_k.x[k] - s_r.x[k]).abs().max()) for k in s_k.x)
    print(f"[mlp] kernel vs ref backend: max |x diff| {diff}")
    if not diff <= 1e-6:
        raise AssertionError(f"kernel and ref trajectories differ: {diff}")
    if n_k != {"ef_track": rounds, "ef_step": rounds}:
        raise AssertionError(f"kernel backend launches: {n_k}")
    if n_r != {"ef_track": 0, "ef_step": 0}:
        raise AssertionError(f"ref backend launched kernels: {n_r}")
    first, last = statistics.mean(l_k[:20]), statistics.mean(l_k[-20:])
    if not last < first:
        raise AssertionError(f"MLP loss did not fall: {first} -> {last}")

    # the timing turns run the other way round (kernel, ref, ref, kernel),
    # then one profiled window per backend
    ms_per_round = {b: [out[b][2]] for b in out}
    for backend in ("ref", "kernel"):
        algo = api.build(base.replace(comm_backend=backend), loss_fn)
        _, _, ms = run_timed(torch, runtime.run_chunked, algo, source,
                             algo.init(paper.mlp_init(seed=0)), 0, rounds, 50)
        ms_per_round[backend].append(ms)
    print(f"[mlp] ms/round in turns (kernel, ref, ref, kernel): "
          f"{ms_per_round}")
    for backend in ("kernel", "ref"):
        algo = api.build(base.replace(comm_backend=backend), loss_fn)
        profile_rounds(torch, runtime, algo, source,
                       algo.init(paper.mlp_init(seed=0)), 20, backend)

    algo = api.build(base.replace(algo="porter-dp", sigma_p=0.01), loss_fn)
    state = algo.init(paper.mlp_init(seed=0))
    ops.reset_launches()
    state, losses, ms = run_timed(torch, runtime.run_chunked, algo, source,
                                  state, 0, dp_rounds, dp_rounds // 2)
    dp_launches = dict(ops.LAUNCHES)
    print(f"[mlp] porter-dp {dp_rounds} rounds: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, {ms:.4f} ms/round, launches {dp_launches}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError("porter-dp loss is not finite")
    if dp_launches != {"ef_track": dp_rounds, "ef_step": dp_rounds}:
        raise AssertionError(f"porter-dp launches: {dp_launches}")
    return n_k, ms_per_round


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api, data
    from repro_torch.core import average_params
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import runtime
    from repro_torch.models import paper

    # phase 0: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()} torch "
          f"{torch.__version__} cuda {torch.version.cuda} tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")

    # phase 1: build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    # phase 2: kernels against their plain versions
    table = phase_kernels(torch, ops, ref)

    # phase 3: Section-5.1 quickstart through the port's entry points
    phase_quickstart(torch, ops, api, data, runtime, average_params)

    # phase 4: Section-5.2 MLP at full width (the main path's launches)
    launches, ms_per_round = phase_mlp(torch, ops, api, data, runtime, paper)
    print(f"[mlp] median ms/round: " + ", ".join(
        f"{b} {statistics.median(v):.4f}" for b, v in ms_per_round.items()))

    record = []
    for name in KERNELS:
        row = table[(name, MAIN_PLANE)]
        record.append(dict(
            name=name, ok=row["equal"], route="cuda",
            source="src/repro_torch/csrc/ef_update.cu",
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None))
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

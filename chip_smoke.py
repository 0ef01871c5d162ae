#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  It imports nothing of JAX or
of the ``repro`` package.  Phases, each printing its own lines:

0. device: the card's name and power limit (``nvidia-smi``), versions, TF32.
1. build: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` into
   ``build/kernels/``, one process per source, all at once.
2. kernels: ``ef_track`` / ``ef_step`` / ``ef_gossip`` (all-f32, the
   bf16-operand / f32-output mixes, and the bf16 mixes with the
   stochastic-rounding epilogue the engine issues under bf16 planes) and
   the standalone ``sr_cast`` against their plain PyTorch versions on the
   card, bitwise, at the main-path plane sizes and at 2^24 elements, timed
   with CUDA events beside their bandwidth bound; the epilogue variants
   also bitwise the kernel's own two steps (f32 outputs, then ``sr_cast``)
   and on edge values (signed zeros, low halves at or above 0x8000,
   magnitudes near the largest finite bf16), timed beside those two
   steps.
3. the Section-5.1 quickstart (PORTER-GC, logistic regression, 10 agents,
   ER(0.8), top-k 5 %) for 400 rounds through ``build`` + ``run_chunked``,
   with f32 and with bf16 EF planes: the ``gn < 0.1`` gate, the bf16 final
   loss within 0.02 of the f32 one, and each kernel's launches.
4. the Section-5.2 MLP at full width (784 -> 64 -> 10): PORTER-GC for 200
   rounds on the kernel and on the ref backend from one seed (they must
   agree), in f32 and with bf16 planes (half the EF bytes); PORTER-DP;
   CHOCO-SGD in f32 and bf16 (``ef_gossip``); DSGD, DP-SGD and SoteriaFL.
5. the bit-packed wire (``wire="packed_bits"``, ``gossip_mode="packed"``):
   ``topk_pack`` / ``topk_unpack`` / ``qsgd_pack`` / ``qsgd_unpack``
   against their plain versions, bitwise, at the MLP's and the logreg's
   codec rows and at 2^24 elements (``topk_pack`` also at k = 1 and 2048,
   and on tie, sparse, zero, -0.0 and all-equal windows; ``topk_unpack``
   also on repeated, order-dependent, out-of-window and decreasing
   indices against the plain version on the CPU; the QSGD pair at levels
   1, 3, 7, 15, 16, 127, 255 and 32767, one for each fields-a-word count,
   so every route of both kernels runs, and ``qsgd_pack`` on zero,
   one-nonzero, all-negative, -0.0 and subnormal windows), timed beside
   their bound (QSGD at 7 and 16 levels); then
   PORTER-GC on the full-width MLP for 200 rounds on both backends with
   top-k 5 % in f32 and bf16 and QSGD (7 levels) in f32: kernel == ref
   bitwise on x, the launches per round, and the measured wire bytes equal
   to the model.  The quickstart of phase 3 also runs once on this wire.
6. the rwkv6 serving path: ``rwkv6_chunk`` (through ``ops.rwkv6_scan``)
   against its plain version ``ref.rwkv6_chunk_ref`` at the path's shapes
   (4 x 512 tokens, 64 heads x 64, bf16 r, k, v), at 2 x 4096 tokens, in
   each of the kernel's other builds (f32 r, k, v; widths 32, 16) and at
   head dims padded on chip (8, 5, 48), with a state-chaining check, timed
   beside its bound (``scan_bound``: the bytes over HBM bandwidth against
   the operations on the tensor cores, the earlier f32-rate figure printed
   beside it), and N = 65 refused (``[rwkv6]`` lines); then rwkv6-7b at full width and depth (32 layers, d 4096,
   vocab 65536), its parameters drawn on the card from a seed, serving
   batch 4 x prompt 512 and 32 greedy decode steps through
   ``launch.serve`` (32 kernel launches a prefill, finite logits, ids in
   range, prefill and decode tokens/s, the scans' share of a profiled
   prefill); then 4 layers in f32: decode after a 512-token prefill held
   against ``forward`` over 528 tokens at 2e-3.
7. the zamba2 serving path: ``ssd_chunk`` (through ``ops.ssd_scan``)
   against its plain version ``ref.ssd_chunk_ref`` at the path's shape (4
   x 512 tokens, 112 heads x 64, state 64) with bf16 and with f32 B / C
   (read in place as column slices of one activation, as the model passes
   them), at 2 x 4096 tokens, and at other (P, N) in both B / C dtypes
   (the zamba2 smoke config's 32 x 16, the reference kernel test's 8 x 16
   and 16 x 8, and 5 x 7), with a state-chaining check, timed beside its
   bound (``scan_bound``), and P or N of 65 refused (``[ssd]`` lines); the
   zamba2 smoke config served on the card (a 128-token prefill, 5
   launches; in f32, prefill and 64 decode steps against ``forward`` at
   2e-3); then zamba2-7b at full width and depth (81
   Mamba2 layers of d 3584, the shared attention + MLP block 13 times,
   vocab 32000; 6,637,023,440 parameters drawn on the card from a seed),
   serving batch 4 x prompt 512 and 32 greedy decode steps through
   ``launch.serve`` (81 kernel launches a prefill and none in decode,
   finite logits, ids in range, prefill and decode tokens/s, resident and
   peak memory, a profiled prefill and decode step); then 13 layers in f32
   (2 groups with the shared block and 1 trailing layer): decode after a
   512-token prefill held against ``forward`` over 576 tokens at 2e-3
   (``[zamba2]`` lines).
8. the clip kernels: the fused ``clip`` (``csrc/smooth_clip.cu``, one
   launch through ``ops.clip_planes``, its route printed) against its plain
   composition, bitwise with its partials and factors, at every clip plane
   (the MLP's agent plane, 10 rows x 7 tiles; the quickstart's, 10 x 1;
   PORTER-DP's per-sample plane, 80 x 7; the DP perturbation's, 1 x 63;
   2^24 elements as 1 and 16 rows) in f32 and bf16 at tau 0.3, 1 and 4,
   and in its noise form on the MLP's plane, timed beside its bound, the
   wrapper calls it stands for (``sumsq`` + ``smooth_factors`` +
   ``scale``) and the two kernels alone, and once captured in a CUDA graph
   and replayed; then
   the passes alone, ``sumsq``, ``scale`` and ``scale_noise``, against
   their plain versions, bitwise, at the same planes, timed beside their
   bound, the PyTorch call for the same function (``torch.linalg.vecdot``,
   ``torch.mul``) and the nearest one (``[clip]`` lines); ``mean_noise``
   (the DP perturbation of the clipped samples' mean, one launch through
   ``ops.dp_mean_noise``) against ``ref.dp_mean_noise_ref``, bitwise, on
   the MLP's real per-sample plane (10 agents x 8 samples x 7 tiles, f32
   and bf16) and on synthetic planes (1 and 10 groups, b = 1, 3, 8, 32,
   -0.0 samples among them, f32 and bf16), timed beside its bound, the
   PyTorch call for the same function in f32 (``torch.baddbmm``), the
   eager route it replaced (``sum``, ``/ b``, the re-pack, ``ones``,
   ``scale_noise``) and the whole DP route from the clipped plane to the
   perturbed tree in this tree's form and the parent's
   (``[mean_noise]`` lines); the row-stacked clip of a real MLP gradient
   against the plain composition, its perturbation against ``g + sigma *
   z``, and the DP gradient (``clipping.dp_gradient``) against the clip
   and ``dp_mean_noise_ref`` on the same CUDA tensors; PORTER-GC and
   PORTER-DP rounds with the clip kernels against the same rounds with the
   plain clip and mean on the card, x bitwise;
   ``block_topk`` (``csrc/block_topk.cu``) bitwise at the MLP's w1 windows
   (250 x 2048, k = 1, 102, 512, 2048), on tie, zero and -0.0 windows and
   at 2^24 elements, beside ``torch.topk`` + ``scatter``
   (``[block_topk]``); the host's µs a wrapper call against a PyTorch op
   (``[host]``); then PORTER-GC on the full-width MLP with the
   ``block_top_k`` compressor (5 %) for 200 rounds, f32 and bf16, kernel
   and ref backends, with the MLP phase's gates (``[block_top_k]``).  The
   clip runs outside the comm round, so every PORTER-GC, DSGD and CHOCO
   round of the earlier phases also counts one ``clip`` launch, on the ref
   backend too, and every DP round one ``mean_noise``; no path launches
   ``sumsq``, ``scale`` or ``scale_noise``.
9. time-varying and directed schedules and the registry's last four
   algorithms on the same MLP (``[extensions]`` lines): PORTER-GC for 200
   rounds on the ``erdos_renyi`` (period 8), ``dropout`` and
   ``straggler`` schedules, kernel vs ref backend (x within 1e-6 in f32,
   bitwise in bf16), and a period-1 ``static`` schedule bitwise the
   static graph's final state of phase 4; porter-adam in f32 and bf16
   (f32 moments), clip21 (and at tau = inf bitwise porter-gc with a
   piecewise clip at tau = inf), subgrad-comp with ``sign`` (200 rounds)
   and ``low_rank`` (50); dp-csgp (sigma_p 0.01, 50 rounds) on a directed
   ring with a skip and on a random digraph of period 8 in f32 and bf16
   and over the packed wire, the push-sum weights summing to n and
   positive, and bitwise PORTER-DP on the static ER(0.8) table; each
   run's ms a round and launches, and three profiled windows.
10. fleet-scale agents and checkpoints (``[fleet]``, ``[checkpoint]``
   lines): the n = 4096 rung of ``benchmarks/fleet_ablation.py`` (Section
   5.1's logreg on Dirichlet(0.3) shards of 16, batch 4, the exponential
   graph above the dense gate: the COO mixer) through ``run_chunked`` at
   chunk 8, clip21 and PORTER-GC for 40 rounds and PORTER-DP for 16 (its
   per-sample plane 16,384 rows): ms a round, the kernels' launches a
   round, the COO mixer's kernels and µs an apply, the EF plane bytes (one
   8,192-element tile an agent for 124 parameters), the loss falling
   (finite for PORTER-DP); the COO apply on the card twice bitwise, against
   the CPU's (1e-6, bitwise printed) and against ``densify(t) @ x`` on a
   4-round ER schedule (1e-5), push included; n = 256 (the gate) fleet vs
   per-device engine, final state bitwise; save at round 4 of 8 on
   ``rotate:ring+complete+star`` (mid-period), restore into a fresh build,
   continue: bitwise the uninterrupted run, for PORTER-GC on the MLP in f32
   and bf16 planes and clip21 on the n = 4096 fleet, the MLP's checkpoint
   also restored bitwise into a CPU-built state; bytes and seconds.
11. the last eight architectures (``[decoder]`` lines): the smoke configs
   of tinyllama-1.1b, chatglm3-6b, h2o-danube-3-4b, minicpm3-4b (MLA),
   paligemma-3b (VLM), seamless-m4t-medium (encoder-decoder), grok-1-314b
   and arctic-480b (MoE) in f32 on the card, decode after prefill against
   ``forward`` at 2e-3 (window None, capacity factor 4: the reference
   oracle's settings), and the danube one decoding past its 32 window;
   then each at full width (grok-1 at 4 of 64 layers, arctic at 1 of 35:
   what the card holds while drawing), its drawn parameter count checked,
   serving batch 4 x prompt 512 and 32 greedy decode steps through
   ``launch.serve`` (prefill and decode tokens/s, peak memory, ids in
   range, no kernel launched: these families run no Pallas kernel in the
   reference either), one decode step and one prefill of minicpm3-4b and
   grok-1 profiled; then in f32 at a few layers (minicpm3, chatglm3,
   paligemma at 4, seamless at 4 + 4, grok-1 at 1) decode after a
   512-position prefill against ``forward`` at 2e-3.

12. LM training (``[lm-train]`` lines): tinyllama-1.1b at its published
   width, 2 of its 22 layers (219,162,624 parameters an agent), 4 agents
   on a ring, PORTER-GC with ``top_k`` 5 %, tau 1, eta 3e-2, batch 4 x 64
   tokens, bf16 EF planes (an f32 round does not fit in 80 GB), through
   ``launch.steps.build_train_step``: 20 rounds in chunks of 10 after a
   warm chunk, each round's old state donated (ms a round, one
   ``ef_track``, ``ef_step`` and ``clip`` a round and five epilogue
   roundings, the peak memory), one round with each of those
   kernels held bitwise against its plain version on the round's own
   planes (4 rows x 26,754 tiles; the clip on the cooperative route), a
   profiled window (the device's busy share), one round on the kernel
   backend against the ref backend (top_k 1.0, x within 1e-6); the three
   kernels timed at that plane beside their plain versions and bounds (the
   ef kernels in f32 and with the bf16 epilogue);
   ``build_train_step``'s default ``block_top_k`` for 2 rounds
   (``block_topk`` bitwise on every leaf of a round, timed on the
   embedding leaf); every architecture's smoke config trained for 5
   rounds by ``launch.train.main`` (no scan kernel launched: the loss runs
   the scans' plain chunked forms), its f32 loss and gradient on the card
   within 1e-4 of the CPU's, and the scan wrappers refusing operands under
   ``torch.func``; one full-width gradient with ``remat_policy`` "full"
   and "dots" against none (1e-6, each call's peak and its rise over the
   resident parameters); PORTER-DP on tinyllama's smoke config (one
   ``mean_noise`` a round), and every other registered algorithm and the
   fleet through ``main`` for 2 rounds.

Every path is driven with the launch counts set to 0 just before it and
read just after.  Any failure raises and exits non-zero.  The line before
the last is the kernels' JSON record; the last line is the device record.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the tensor cores' dense TF32 rate: a scan's products at f32-accurate
# results take at least three TF32 passes there (hi.hi + hi.lo + lo.hi)
TF32_OPS_PER_S = 495e12

TILE = 8 * 1024
PLANES = {"mlp": 10 * 7 * TILE,      # Section-5.2 MLP: d=50,890 -> 7 tiles
          "logreg": 10 * 1 * TILE,   # Section-5.1 logreg: d=124 -> 1 tile
          "2^24": 1 << 24}
MAIN_PLANE = "mlp"
GAMMA, ETA, SCALE = 0.0142897, 0.05, 1.0
# Each variant: its kernel, the dtypes of the EF operands and of slot 2
# (v / x / y), whether it writes f32, the outputs it rounds stochastically
# in its epilogue (``sr``), and per element the bytes it must move (each
# operand read once, each output written once) and its arithmetic
# operations.  The ``_sr`` mixes are the ones the engine issues under
# bf16 planes: bf16 EF operands, each bf16 output rounded with its int32
# word (4 B read and 2 B written an output, an and, an add and a shift).
# The ``out_f32`` mixes (``_bf16``) are no path's: they are the first step
# of the two-step reference (f32 outputs, then ``sr_cast``) that the
# ``_sr`` mixes are held against, checked here as a mode of the kernel.
VARIANTS = {
    "ef_track": dict(kernel="ef_track", n_in=7, ef="f32", y="f32",
                     out_f32=False, bytes=40, ops=7),
    "ef_step": dict(kernel="ef_step", n_in=6, ef="f32", y="f32",
                    out_f32=False, bytes=36, ops=7),
    "ef_gossip": dict(kernel="ef_gossip", n_in=5, ef="f32", y="f32",
                      out_f32=False, bytes=32, ops=7),
    "ef_track_bf16": dict(kernel="ef_track", n_in=7, ef="bf16", y="bf16",
                          out_f32=True, bytes=7 * 2 + 3 * 4, ops=7),
    "ef_step_bf16": dict(kernel="ef_step", n_in=6, ef="bf16", y="f32",
                         out_f32=True, bytes=5 * 2 + 4 + 3 * 4, ops=7),
    "ef_gossip_bf16": dict(kernel="ef_gossip", n_in=5, ef="bf16", y="f32",
                           out_f32=True, bytes=4 * 2 + 4 + 3 * 4, ops=7),
    "ef_track_bf16_sr": dict(kernel="ef_track", n_in=7, ef="bf16", y="bf16",
                             out_f32=False, sr=3,
                             bytes=7 * 2 + 3 * (4 + 2), ops=7 + 3 * 3),
    "ef_step_bf16_sr": dict(kernel="ef_step", n_in=6, ef="bf16", y="f32",
                            out_f32=False, sr=2,
                            bytes=5 * 2 + 4 + 2 * (4 + 2) + 4,
                            ops=7 + 2 * 3),
    "ef_gossip_bf16_sr": dict(kernel="ef_gossip", n_in=5, ef="bf16",
                              y="f32", out_f32=False, sr=2,
                              bytes=4 * 2 + 4 + 2 * (4 + 2) + 4,
                              ops=7 + 2 * 3),
    # f32 in, int32 random words in (low 16 bits used), bf16 out; an and,
    # an add and a shift, counted at the f32 rate
    "sr_cast": dict(kernel="sr_cast", bytes=4 + 4 + 2, ops=3),
}
KERNELS = {
    "ef_track": dict(source="src/repro_torch/csrc/ef_update.cu",
                     replaces="src/repro/kernels/ef_update.py:69",
                     variant="ef_track"),
    "ef_step": dict(source="src/repro_torch/csrc/ef_update.cu",
                    replaces="src/repro/kernels/ef_update.py:96",
                    variant="ef_step"),
    "ef_gossip": dict(source="src/repro_torch/csrc/ef_update.cu",
                      replaces="src/repro/kernels/ef_update.py:130",
                      variant="ef_gossip"),
    "sr_cast": dict(source="src/repro_torch/csrc/sr_cast.cu",
                    replaces="src/repro/kernels/sr_cast.py:65",
                    variant="sr_cast"),
}
# bytes of operands rotated through per timing, twice the H100's 50 MB L2
L2_FLUSH_BYTES = 100 * 2**20

# the wire codecs: PACK_BLOCK windows; codec rows per size (agents x
# windows: the MLP's w1 pads to 25 windows and c1, w2, c2 to one each; the
# logreg's b and w to one each); kept elements k = round(frac * 2048) and
# QSGD levels; the main path's variant of each kernel
PACK_BLOCK = 2048
WIRE_ROWS = {"mlp": 10 * 28, "logreg": 10 * 2, "2^24": (1 << 24) // 2048}
TOPK_K = {"0.05": 102, "0.25": 512}
# topk_pack alone at the ends of k: the frac 1/2048 and the whole window
TOPK_PACK_ENDS = {"1/2048": 1, "1": 2048}
# QSGD levels: field widths 2, 3, 4, 5, 6, 8, 9 and 16 bits, one level for
# each of the eight fields-a-word counts (epw 16, 10, 8, 6, 5, 4, 3, 2), so
# every route of both QSGD kernels runs: qsgd_pack's words in registers at
# 7, 127 and 32767 levels, a shuffle joining two threads' halves at 1,
# shared fields at 3, 15, 16 and 255; qsgd_unpack's template instance of
# each epw; the kernels are timed at QSGD_TIMED
QSGD_LEVELS = (1, 3, 7, 15, 16, 127, 255, 32767)
QSGD_TIMED = (7, 16)
WIRE_KERNELS = {
    "topk_pack": dict(replaces="src/repro/kernels/wire_pack.py:79",
                      variant="topk_pack k=102"),
    "topk_unpack": dict(replaces="src/repro/kernels/wire_pack.py:107",
                        variant="topk_unpack k=102"),
    "qsgd_pack": dict(replaces="src/repro/kernels/wire_pack.py:158",
                      variant="qsgd_pack levels=7"),
    "qsgd_unpack": dict(replaces="src/repro/kernels/wire_pack.py:192",
                        variant="qsgd_unpack levels=7"),
}
# per element, the operations the codecs do on their inputs, counted at the
# f32 rate: topk_pack's key (|x|) and max, the radix select's at most four
# digit passes of a prefix compare and a histogram add (its 24 bisection
# steps run on two scalars a window), the compaction's compare and count;
# qsgd_pack's square, add, divide, multiply, floor, subtract, compare, add;
# the unpacks' shift, mask and two products
WIRE_OPS = {"topk_pack": 2 + 4 * 2 + 2, "topk_unpack": 1, "qsgd_pack": 8,
            "qsgd_unpack": 4}
# the bytes one exchange of one buffer ships on the MLP (n = 10, 28 windows
# an agent): topk_bits 4 B x 102 kept a window, qsgd_bits 256 words + scale
WIRE_BYTES_MLP = {"top_k": 10 * 28 * 4 * 102, "qsgd": 10 * 28 * (4 * 256 + 4)}


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


def device_time_ms(fn, arg_sets, reps: int = 50, inner: int = 20,
                   cover: bool = False) -> float:
    """Median device time of one call, from CUDA events around ``inner``
    back-to-back calls that rotate through ``arg_sets``.  A sleep kernel
    queued first keeps the card busy while the host enqueues the calls, so
    the events bracket device work and not the host's launch rate.  With
    ``cover``, each sample also checks that the sleep was still running
    when the last call was enqueued (the start event not yet reached); if
    it was not, the sleep doubles and the samples start again, and a sleep
    of 2^7 times the first that still ends first raises.  That is for a
    ``fn`` of several wrapper calls, whose enqueue can outlast the sleep;
    ``fn`` must not synchronize."""
    import torch
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    cycles, samples = 5_000_000, []
    while len(samples) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(inner):
            fn(*arg_sets[i % len(arg_sets)])
        late = cover and start.query()
        end.record()
        end.synchronize()
        if late:
            if cycles >= 5_000_000 << 7:
                raise RuntimeError(
                    f"enqueueing {inner} calls outlasts a sleep of {cycles} "
                    "cycles: the time would be the host's")
            cycles, samples = 2 * cycles, []
            continue
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound_ms(variant: str, n: int):
    """Least time for the card: bytes over HBM bandwidth vs operations over
    the f32 rate; returns (ms, 'bytes' | 'operations')."""
    v = VARIANTS[variant]
    t_bytes = v["bytes"] * n / HBM_BYTES_PER_S
    t_ops = v["ops"] * n / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def scan_bound(moved: int, flops: int):
    """Least time for the card for a scan: (ms, 'bytes' | 'operations',
    and in seconds the bytes over HBM bandwidth, the operations on the
    tensor cores as three TF32 passes, and the operations at the f32 rate
    outside the tensor cores, the bound these scans were first held to)."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_tc = 3 * flops / TF32_OPS_PER_S
    return (1e3 * max(t_bytes, t_tc),
            "bytes" if t_bytes >= t_tc else "operations", t_bytes, t_tc,
            flops / F32_OPS_PER_S)


def bound_text(moved: int, flops: int) -> str:
    """The parts of ``scan_bound`` for a log line."""
    ms, by, t_bytes, t_tc, t_f32 = scan_bound(moved, flops)
    return (f"bound_us={1e3 * ms:.3f} ({by}: {moved} B -> "
            f"{1e6 * t_bytes:.3f} us; {flops} flop as three TF32 passes -> "
            f"{1e6 * t_tc:.3f} us; at the f32 rate, the earlier bound, -> "
            f"{1e6 * t_f32:.3f} us)")


def bit_equal(torch, a, b) -> bool:
    """Same dtype and the same bits (``torch.equal`` would let -0.0 pass
    for 0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(as_int), b.view(as_int))


def _words(torch, gen, shape):
    """Random int32 words over the whole range (the high bits set, to be
    ignored: only the low 16 round)."""
    return torch.randint(-(2**31), 2**31 - 1, shape, generator=gen,
                         device=DEVICE, dtype=torch.int32)


# (q, c) pairs, taken to bf16, whose f32 sum q + c is an edge of the
# stochastic rounding: signed zeros, low halves 0x8000, 0xC000 and 0xFF00,
# magnitudes whose rounding up passes the largest finite bf16 (0x7F7F8000
# + r may carry into the exponent), subnormals
SR_EDGE_QC = ((0.0, 0.0), (-0.0, -0.0), (0.0, -0.0), (1.0, 2.0 ** -8),
              (-1.0, -2.0 ** -8), (1.0, 1.5 * 2.0 ** -8),
              (1.0, 255 * 2.0 ** -15), (3.3895314e38, 2.0 ** 119),
              (-3.3895314e38, -2.0 ** 119), (2.0 ** -130, 2.0 ** -133),
              (0.1, -0.3))


def _variant_fns(torch, ops, ref, name):
    """(kernel call, plain call, operand maker, two-step call, edge maker)
    of one variant; the last two only for the epilogue variants (the
    kernel's ``out_dtype=f32`` outputs, then ``ops.sr_cast`` on each output
    given words; operands with q = m and c = wc from ``SR_EDGE_QC``)."""
    v = VARIANTS[name]
    if name == "sr_cast":
        def make(gen, n):
            x = torch.randn(n // TILE, TILE, generator=gen, device=DEVICE)
            return [x, _words(torch, gen, x.shape)]
        return ((lambda *a: (ops.sr_cast(*a),)),
                (lambda *a: (ref.sr_cast_ref(*a),)), make, None, None)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    scalars = {"ef_track": (GAMMA,), "ef_step": (GAMMA, ETA),
               "ef_gossip": (GAMMA, SCALE)}[v["kernel"]]
    od = torch.float32 if v["out_f32"] else None
    kern, plain = getattr(ops, v["kernel"]), getattr(ref, v["kernel"] + "_ref")
    n_in, n_sr = v["n_in"], v.get("sr", 0)

    def make(gen, n):
        return ([torch.randn(n // TILE, TILE, generator=gen, device=DEVICE)
                 .to(dt[v["y"] if i == 2 else v["ef"]])
                 for i in range(n_in)]
                + [_words(torch, gen, (n // TILE, TILE))
                   for _ in range(n_sr)])
    if not n_sr:
        return ((lambda *a: kern(*a, *scalars, out_dtype=od)),
                (lambda *a: plain(*a, *scalars, out_dtype=od)), make, None,
                None)

    def words(a):
        return tuple(a[n_in:]) + (None,) * (3 - n_sr)

    def composite(fn, cast):
        def call(*a):
            outs = fn(*a[:n_in], *scalars, out_dtype=torch.float32)
            return tuple(o if w is None else cast(o, w)
                         for o, w in zip(outs, words(a)))
        return call

    def make_edge(gen, n):
        a = make(gen, n)
        pairs = torch.tensor(SR_EDGE_QC, device=DEVICE).repeat(
            -(-n // len(SR_EDGE_QC)), 1)[:n]
        for slot, col in ((0, 0), (1, 0), (3, 1), (4, 1)):
            a[slot] = pairs[:, col].reshape(a[slot].shape).to(a[slot].dtype)
        return a
    return ((lambda *a: kern(*a[:n_in], *scalars, sr_bits=words(a))),
            composite(plain, ref.sr_cast_ref), make,
            composite(kern, ops.sr_cast), make_edge)


def phase_kernels(torch, ops, ref):
    """Each kernel variant against its plain version at every plane size.

    ``ms`` is timed cold: the calls rotate through enough operand sets that
    each call's bytes come from device memory, not from the 50 MB L2 (what
    the HBM bound assumes); ``ms_warm`` repeats one set, whose operands stay
    in L2 when they fit.  An epilogue variant is also held bitwise against
    the kernel's own two steps (f32 outputs, then ``sr_cast``), on its
    random operands and on the edge operands, and ``unfused_ms`` times
    those two steps.
    """
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    table = {}
    for size_name, n in PLANES.items():
        for name in VARIANTS:
            kern, plain, make, two_step, make_edge = _variant_fns(
                torch, ops, ref, name)
            per_call = VARIANTS[name]["bytes"] * n
            n_sets = -(-L2_FLUSH_BYTES // per_call) + 1
            sets = [make(gen, n) for _ in range(n_sets)]
            k_out, p_out = kern(*sets[0]), plain(*sets[0])
            torch.cuda.synchronize()
            equal = all(bit_equal(torch, a, b) for a, b in zip(k_out, p_out))
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(k_out, p_out))
            checks = {"plain": equal}
            if two_step is not None:
                edge = make_edge(gen, n)
                e_out = kern(*edge)
                for label, got, want in (
                        ("two_step", k_out, two_step(*sets[0])),
                        ("edge_plain", e_out, plain(*edge)),
                        ("edge_two_step", e_out, two_step(*edge))):
                    checks[label] = all(bit_equal(torch, a, b)
                                         for a, b in zip(got, want))
                equal = all(checks.values())
                del edge, e_out
            row = dict(elements=n, equal=equal, max_abs_err=err,
                       out_dtypes=[str(a.dtype) for a in k_out],
                       ms=device_time_ms(kern, sets),
                       ms_warm=device_time_ms(kern, sets[:1]),
                       plain_ms=device_time_ms(plain, sets),
                       plain_ms_warm=device_time_ms(plain, sets[:1]),
                       unfused_ms=(device_time_ms(two_step, sets,
                                                  cover=True)
                                   if two_step else None))
            row["bound_ms"], row["bound_by"] = bound_ms(name, n)
            table[(name, size_name)] = row
            print(f"[kernels] {name} {size_name} n={n} bitwise={checks} "
                  f"max_abs_err={err} out={row['out_dtypes']} "
                  f"ms={row['ms']} ms_warm={row['ms_warm']} "
                  f"plain_ms={row['plain_ms']} "
                  f"plain_ms_warm={row['plain_ms_warm']} "
                  + (f"unfused_ms={row['unfused_ms']} " if two_step else "")
                  + f"bound_ms={row['bound_ms']} ({row['bound_by']}, "
                  f"{VARIANTS[name]['bytes']} B/element)")
            if not equal:
                raise AssertionError(f"{name} differs at {size_name}: "
                                     f"{checks}, max |diff| {err}")
            del sets, k_out, p_out
    return table


def run_timed(torch, run_chunked, algo, source, state, seed, steps, chunk,
              **kw):
    """Run ``steps`` rounds (``kw`` to ``run_chunked``); returns (state,
    per-round losses, ms/round).

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
                           on_chunk=keep, **kw)
    (r0, w0), (r1, w1) = stamps[0], stamps[-1]
    return state, torch.cat(losses).tolist(), 1e3 * (w1 - w0) / (r1 - r0)


def run_counted(torch, ops, runtime, algo, source, state, steps, chunk,
                seed=0):
    """``run_timed`` with every launch count set to 0 just before and read
    just after; returns (state, losses, ms/round, launches)."""
    ops.reset_launches()
    state, losses, ms = run_timed(torch, runtime.run_chunked, algo, source,
                                  state, seed, steps, chunk)
    return state, losses, ms, dict(ops.LAUNCHES)


def expect_launches(label, got, **want):
    """Every kernel's count must be ``want`` (0 where not named)."""
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f"{label}: launches {got}, expected {full}")


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
    ours = [e for e in kernels if any(
        name in e.key for name in ("ef_kernel", "sr_kernel", "topk_pack_k",
                                   "topk_unpack_k", "qsgd_pack_k",
                                   "qsgd_unpack_k", "sumsq_kernel",
                                   "scale_kernel", "clip_kernel",
                                   "clip_cluster_kernel",
                                   "mean_noise_kernel",
                                   "block_topk_kernel"))]
    print(f"[profile] {label}: {rounds} rounds, wall {wall_us / rounds:.1f} "
          f"us/round, device busy {busy_us / rounds:.1f} us/round "
          f"({100 * busy_us / wall_us:.2f} %), {launches / rounds:.1f} "
          "kernel launches/round; top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / rounds:.1f} us "
              f"x{e.count / rounds:.1f}" for e in top))
    print(f"[profile] {label}: the port's kernels "
          f"{sum(e.self_device_time_total for e in ours) / rounds:.2f} "
          "us/round: " + ("; ".join(
              f"{e.key.replace('(anonymous namespace)::', '')[:72]} "
              f"{e.self_device_time_total / e.count:.2f} us x"
              f"{e.count / rounds:.1f}" for e in ours) or "none"))


def finite(values) -> bool:
    return all(math.isfinite(v) for v in values)


def phase_quickstart(torch, ops, api, data, runtime, average_params,
                     rounds=400):
    """Section-5.1 protocol, as examples/quickstart.py runs it, with f32 and
    with bf16 EF planes, and in f32 on the bit-packed wire."""
    x, y = data.a9a_like(num=20000, dim=123, seed=0)
    xs, ys = data.shard_to_agents(x, y, 10)
    source = data.minibatch_source(xs, ys, batch=8, device=DEVICE)
    spec = api.ExperimentSpec(algo="porter-gc", n_agents=10,
                              topology="erdos_renyi",
                              topology_weights="best_constant",
                              topology_p=0.8, topology_seed=1,
                              compressor="top_k", frac=0.05, eta=0.05,
                              tau=1.0)
    full = (torch.as_tensor(xs.reshape(-1, 123), device=DEVICE),
            torch.as_tensor(ys.reshape(-1), device=DEVICE))
    final = {}
    runs = {"f32": {}, "bf16": dict(plane_dtype="bf16"),
            "packed_bits": dict(wire="packed_bits", gossip_mode="packed")}
    for label, over in runs.items():
        algo = api.build(spec.replace(**over), logreg_loss, device=DEVICE)
        state = algo.init({"w": torch.zeros(123), "b": torch.zeros(())})
        state, losses, ms, launches = run_counted(
            torch, ops, runtime, algo, source, state, rounds, 50)
        avg = average_params(state.x)
        gn = grad_norm(logreg_loss, avg, full)
        full_loss = float(logreg_loss(avg, full))
        final[label] = losses[-1]
        print(f"[quickstart] porter-gc {label} {rounds} rounds: loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}, full-data loss at "
              f"x-bar {full_loss:.6f}, gn {gn:.6f}, {ms:.4f} ms/round, "
              f"launches {launches}")
        if not gn < 0.1:
            raise AssertionError(f"quickstart {label} gate failed: gn = {gn}")
        # every round clips the agents' gradients once (one fused clip)
        if label == "f32":
            expect_launches("quickstart f32", launches, ef_track=rounds,
                            ef_step=rounds, clip=rounds)
            profile_rounds(torch, runtime, algo, source, state, 20,
                           "quickstart")
        elif label == "bf16":
            # 3 bf16-bound outputs of ef_track + 2 of ef_step each round,
            # rounded in the ef kernels' epilogue: no sr_cast launch
            expect_launches("quickstart bf16", launches, ef_track=rounds,
                            ef_step=rounds, sr_epilogue=5 * rounds,
                            clip=rounds)
        else:
            # each of the two exchanges a round packs and unpacks once
            expect_launches("quickstart packed_bits", launches,
                            ef_track=rounds, ef_step=rounds,
                            topk_pack=2 * rounds, topk_unpack=2 * rounds,
                            clip=rounds)
    gap = abs(final["f32"] - final["bf16"])
    print(f"[quickstart] final loss f32 {final['f32']:.6f} bf16 "
          f"{final['bf16']:.6f}: gap {gap:.6f} (gate 0.02)")
    if not gap <= 0.02:
        raise AssertionError(f"bf16 final loss is {gap} from f32's")


# sigma_p of every DP run on the MLP (PORTER-DP, DP-SGD, SoteriaFL)
DP_SIGMA = 0.01


def _mlp_problem(api, data, paper, num):
    x, y = data.mnist_like(num=num, seed=0)
    xs, ys = data.shard_to_agents(x, y, 10)
    source = data.minibatch_source(xs, ys, batch=8, device=DEVICE)
    base = api.ExperimentSpec(algo="porter-gc", n_agents=10,
                              topology="erdos_renyi",
                              topology_weights="best_constant",
                              topology_p=0.8, topology_seed=1,
                              compressor="top_k", frac=0.05, eta=0.2,
                              tau=1.0)
    return source, base, paper.mlp_loss()


def _build(api, spec, loss_fn):
    return api.build(spec, loss_fn, device=DEVICE)


def _init(algo, paper):
    return algo.init(paper.mlp_init(seed=0, device=DEVICE))


def _falls(label, losses, window=20):
    first = statistics.mean(losses[:window])
    last = statistics.mean(losses[-window:])
    if not last < first:
        raise AssertionError(f"{label}: loss did not fall: {first} -> {last}")


EF_FIELDS = ("v", "q_x", "q_v", "g_prev", "m_x", "m_v")


def ef_nbytes(state, tree_leaves) -> int:
    return sum(leaf.nbytes for f in EF_FIELDS
               for leaf in tree_leaves(getattr(state, f)))


def phase_mlp(torch, ops, api, data, runtime, paper, tree_leaves, num=60000,
              rounds=200, dp_rounds=50):
    """Section-5.2 MLP at full width: PORTER-GC kernel vs ref backend in f32
    and with bf16 planes, their ms/round in turns, then PORTER-DP."""
    source, base, loss_fn = _mlp_problem(api, data, paper, num)
    runs = {}
    for plane in (None, "bf16"):
        label = plane or "f32"
        for backend in ("kernel", "ref"):
            algo = _build(api, base.replace(comm_backend=backend,
                                          plane_dtype=plane), loss_fn)
            runs[(label, backend)] = run_counted(
                torch, ops, runtime, algo, source,
                _init(algo, paper), rounds, 50)
            _, losses, ms, launches = runs[(label, backend)]
            print(f"[mlp] porter-gc {label} {backend} {rounds} rounds: loss "
                  f"{losses[0]:.6f} -> {losses[-1]:.6f}, {ms:.4f} ms/round, "
                  f"launches {launches}")
        (s_k, l_k, _, n_k), (s_r, _, _, n_r) = (runs[(label, "kernel")],
                                                runs[(label, "ref")])
        diff = max(float((s_k.x[k] - s_r.x[k]).abs().max()) for k in s_k.x)
        same = all(bit_equal(torch, s_k.x[k], s_r.x[k]) for k in s_k.x)
        print(f"[mlp] {label} kernel vs ref backend: x bitwise equal {same}, "
              f"max |x diff| {diff}")
        if plane is None:
            if not diff <= 1e-6:
                raise AssertionError(f"kernel and ref trajectories differ: "
                                     f"{diff}")
            expect_launches("mlp f32 kernel", n_k, ef_track=rounds,
                            ef_step=rounds, clip=rounds)
        else:
            # both backends read the same plane of SR words per output
            if not same:
                raise AssertionError(f"bf16 kernel and ref trajectories "
                                     f"differ: {diff}")
            expect_launches("mlp bf16 kernel", n_k, ef_track=rounds,
                            ef_step=rounds, sr_epilogue=5 * rounds,
                            clip=rounds)
        # the clip sits outside the comm round: the ref backend clips
        # through the kernels too
        expect_launches(f"mlp {label} ref", n_r, clip=rounds)
        _falls(f"mlp porter-gc {label}", l_k)

    s32, s16 = runs[("f32", "kernel")][0], runs[("bf16", "kernel")][0]
    b32, b16 = ef_nbytes(s32, tree_leaves), ef_nbytes(s16, tree_leaves)
    dtypes = sorted({str(leaf.dtype) for f in EF_FIELDS
                     for leaf in tree_leaves(getattr(s16, f))})
    print(f"[mlp] resident EF bytes (six buffers, tensor.nbytes): f32 {b32}, "
          f"bf16 {b16} {dtypes}, x {sorted({str(v.dtype) for v in s16.x.values()})}, "
          f"ratio {b32 / b16}")
    if b32 != 2 * b16:
        raise AssertionError(f"bf16 EF bytes {b16} are not half of {b32}")

    # the timing turns, after the four runs above (f32 kernel, f32 ref, bf16
    # kernel, bf16 ref): the f32 backends run kernel, ref, ref, kernel, and
    # counting those four runs the kernel backend's planes run f32, bf16,
    # f32, bf16, f32, f32, bf16, bf16, f32; then one profiled window each
    ms_per_round = {f"{plane} {backend}": [runs[(plane, backend)][2]]
                    for plane, backend in runs}
    turns = ["f32 ref", "f32 kernel", "bf16 kernel", "f32 kernel",
             "f32 kernel", "bf16 kernel", "bf16 kernel", "f32 kernel"]
    for label in turns:
        plane, backend = label.split()
        algo = _build(api, base.replace(
            comm_backend=backend,
            plane_dtype=None if plane == "f32" else plane), loss_fn)
        _, _, ms = run_timed(torch, runtime.run_chunked, algo, source,
                             _init(algo, paper), 0, rounds, 50)
        ms_per_round[label].append(ms)
    print(f"[mlp] ms/round per run, in run order within each label: "
          f"{ms_per_round}")
    for label, backend, plane in (("kernel", "kernel", None),
                                  ("ref", "ref", None),
                                  ("bf16 kernel", "kernel", "bf16")):
        algo = _build(api, base.replace(comm_backend=backend,
                                      plane_dtype=plane), loss_fn)
        profile_rounds(torch, runtime, algo, source,
                       _init(algo, paper), 20, label)

    algo = _build(api, base.replace(algo="porter-dp", sigma_p=DP_SIGMA),
                  loss_fn)
    _, losses, ms, dp_launches = run_counted(
        torch, ops, runtime, algo, source, _init(algo, paper),
        dp_rounds, dp_rounds // 2)
    print(f"[mlp] porter-dp {dp_rounds} rounds: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, {ms:.4f} ms/round, launches {dp_launches}")
    if not finite(losses):
        raise AssertionError("porter-dp loss is not finite")
    # one clip of all agents' per-sample gradients and one sample mean with
    # its noise a round
    expect_launches("porter-dp", dp_launches, ef_track=dp_rounds,
                    ef_step=dp_rounds, clip=dp_rounds,
                    mean_noise=dp_rounds)
    profile_rounds(torch, runtime, algo, source, _init(algo, paper), 20,
                   "porter-dp")
    return runs, ms_per_round, dp_launches


def phase_baselines(torch, ops, api, data, runtime, paper, num=60000,
                    rounds=200, short=50):
    """The paper's baselines on the full-width MLP: CHOCO-SGD (the
    ``ef_gossip`` path) in f32 and bf16, then DSGD, DP-SGD and SoteriaFL."""
    source, base, loss_fn = _mlp_problem(api, data, paper, num)
    choco = {}
    for plane in (None, "bf16"):
        label = plane or "f32"
        algo = _build(api, base.replace(algo="choco", plane_dtype=plane),
                         loss_fn)
        state, losses, ms, launches = run_counted(
            torch, ops, runtime, algo, source,
            _init(algo, paper), rounds, 50)
        choco[label] = launches
        print(f"[choco] {label} {rounds} rounds: loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}, {ms:.4f} ms/round, q {state.q['w1'].dtype}, "
              f"x {state.x['w1'].dtype}, launches {launches}")
        # the two bf16-bound outputs (q, m) of each round are rounded in
        # ef_gossip's epilogue
        expect_launches(f"choco {label}", launches, ef_gossip=rounds,
                        sr_epilogue=2 * rounds if plane else 0, clip=rounds)
        _falls(f"choco {label}", losses)
    dp = dict(sigma_p=DP_SIGMA)
    for algo_name, plane, over in (("dsgd", None, {}),
                                   ("dp-sgd", None, dp),
                                   ("soteriafl", None, dp),
                                   ("soteriafl", "bf16", dp)):
        algo = _build(api, base.replace(algo=algo_name, plane_dtype=plane,
                                      **over), loss_fn)
        _, losses, ms, launches = run_counted(
            torch, ops, runtime, algo, source,
            _init(algo, paper), short, short // 2)
        print(f"[baselines] {algo_name} {plane or 'f32'} {short} rounds: loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}, {ms:.4f} ms/round, "
              f"launches {launches}")
        if not finite(losses):
            raise AssertionError(f"{algo_name} loss is not finite")
        # each round clips once (dsgd: the agents' gradients; the DP ones:
        # every sample's) and the DP ones take the mean and noise once
        expect_launches(algo_name, launches, clip=short,
                        mean_noise=0 if algo_name == "dsgd" else short)
    return choco


def _wire_variants(torch, ops, ref):
    """Each wire variant: (kernel, its plain version, the operand maker,
    the PyTorch call timed beside it or None, that call's label).  The
    unpacks take the plain pack's buffers of fresh rows as operands."""
    variants = {}

    def nearest(x, k):
        idx = torch.topk(x.abs(), k, dim=1).indices
        return torch.gather(x, 1, idx).to(torch.bfloat16), idx

    for frac, k in TOPK_K.items():
        def make_rows(gen, rows):
            x = torch.randn(rows, PACK_BLOCK, generator=gen, device=DEVICE)
            return [x]

        def make_packed(gen, rows, k=k):
            return list(ref.topk_pack_ref(make_rows(gen, rows)[0], k))


        def scatter(vals, idx):
            return torch.zeros(vals.shape[0], PACK_BLOCK, device=vals.device
                               ).scatter_(1, idx.long(), vals.float())

        variants[f"topk_pack k={k}"] = (
            lambda x, k=k: ops.wire_topk_pack(x, k),
            lambda x, k=k: ref.topk_pack_ref(x, k), make_rows,
            lambda x, k=k: nearest(x, k),
            "nearest call, not the same selection: torch.topk + gather")
        variants[f"topk_unpack k={k}"] = (
            ops.wire_topk_unpack, ref.topk_unpack_ref, make_packed, scatter,
            "the same function: torch.zeros().scatter_(1, idx.long(), "
            "vals.float())")
    for k in TOPK_PACK_ENDS.values():
        variants[f"topk_pack k={k}"] = (
            lambda x, k=k: ops.wire_topk_pack(x, k),
            lambda x, k=k: ref.topk_pack_ref(x, k), make_rows,
            lambda x, k=k: nearest(x, k),
            "nearest call, not the same selection: torch.topk + gather")
    for levels in QSGD_LEVELS:
        def make_noisy(gen, rows):
            x = torch.randn(rows, PACK_BLOCK, generator=gen, device=DEVICE)
            return [x, torch.rand(x.shape, generator=gen, device=DEVICE)]

        def make_words(gen, rows, levels=levels):
            return list(ref.qsgd_pack_ref(*make_noisy(gen, rows), levels))

        variants[f"qsgd_pack levels={levels}"] = (
            lambda x, u, lv=levels: ops.wire_qsgd_pack(x, u, lv),
            lambda x, u, lv=levels: ref.qsgd_pack_ref(x, u, lv),
            make_noisy, None, None)
        variants[f"qsgd_unpack levels={levels}"] = (
            lambda w, sc, lv=levels: ops.wire_qsgd_unpack(w, sc, lv),
            lambda w, sc, lv=levels: ref.qsgd_unpack_ref(w, sc, lv),
            make_words, None, None)
    return variants


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _qsgd_edge_rows(torch, gen, rows):
    """Windows that stress qsgd_pack's norm and fields, in turn: all zero,
    one nonzero, all negative, all -0.0, subnormal magnitudes, Gaussian."""
    x = torch.randn(rows, PACK_BLOCK, generator=gen, device=DEVICE)
    kind = torch.arange(rows, device=DEVICE) % 6
    x[kind == 0] = 0.0
    x[kind == 1] = 0.0
    x[kind == 1, 1234] = -2.5
    x[kind == 2] = -x[kind == 2].abs()
    x[kind == 3] = -0.0
    x[kind == 4] = x[kind == 4] * 1e-40
    return x


def _edge_rows(torch, gen, rows):
    """Windows that stress the selection: small-integer ties, fewer
    nonzeros than k, an all-zero window and a -0."""
    x = torch.randint(-3, 4, (rows, PACK_BLOCK), generator=gen,
                      device=DEVICE).float()
    sparse = torch.rand(x.shape, generator=gen, device=DEVICE) < 0.02
    x[rows // 2:] = x[rows // 2:] * sparse[rows // 2:]
    x[0] = 0.0
    x[1, 3] = -0.0
    return x


def _unpack_edge_packets(torch, rows, k, seed=5):
    """(bf16 values, int16 indices) of ``rows`` windows of k slots, on the
    CPU, of kinds topk_pack never emits, in turn: strictly increasing
    indices (the fast path), random indices with repeats, indices in [0,
    16), 2^30, 1, -2^30 and 2^30, -2^30, 1 on two indices (0 and 1 in slot
    order) among repeats, random u16 indices (most past the window, half
    negative as int16), strictly increasing u16 indices (the fast path,
    dropping those past 2047), decreasing indices, one index for all."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.empty(rows, k, dtype=torch.int64)
    for w in range(rows):
        kind = w % 8
        if kind in (0, 6):
            row = torch.randperm(PACK_BLOCK, generator=g)[:k].sort().values
            idx[w] = row.flip(0) if kind == 6 else row
        elif kind in (1, 3):   # 3: the triples' indices stay their own
            idx[w] = torch.randint(16 * (kind == 3), PACK_BLOCK, (k,),
                                   generator=g)
        elif kind == 2:
            idx[w] = torch.randint(0, 16, (k,), generator=g)
        elif kind == 4:
            idx[w] = torch.randint(0, 1 << 16, (k,), generator=g)
        elif kind == 5:
            idx[w] = torch.randperm(1 << 16, generator=g)[:k].sort().values
        else:
            idx[w] = torch.randint(0, PACK_BLOCK, (1,), generator=g)
    vals = (torch.randn(rows, k, generator=g)
            * 2.0 ** torch.randint(-8, 9, (rows, k), generator=g))
    triple = torch.tensor([2.0 ** 30, 1.0, -2.0 ** 30, 2.0 ** 30,
                           -2.0 ** 30, 1.0])
    vals[3::8, :6] = triple
    idx[3::8, :6] = torch.tensor([9, 9, 9, 4, 4, 4])
    idx = torch.where(idx >= 1 << 15, idx - (1 << 16), idx)
    return vals.to(torch.bfloat16), idx.to(torch.int16)


def phase_wire_kernels(torch, ops, ref, reps=20, inner=10):
    """The four wire kernels against their plain versions, bitwise, at every
    codec size and parameter, timed cold / warm beside their bound (each
    input read once and each output written once, over HBM bandwidth; the
    operations at the f32 rate); QSGD at levels outside ``QSGD_TIMED`` is
    checked only.  ``topk_unpack`` at the MLP's rows also takes the windows
    of ``_unpack_edge_packets``, whose sums at the two order-dependent
    triples must be the slot order's 0 and 1."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    table = {}
    for name, (kern, plain, make, lib, lib_label) in _wire_variants(
            torch, ops, ref).items():
        kernel_name = name.split()[0]
        timed = (not kernel_name.startswith("qsgd")
                 or int(name.split("=")[1]) in QSGD_TIMED)
        for size_name, rows in WIRE_ROWS.items():
            n = rows * PACK_BLOCK
            first = make(gen, rows)
            k_out, p_out = _as_tuple(kern(*first)), _as_tuple(plain(*first))
            torch.cuda.synchronize()
            moved = (sum(t.nbytes for t in first)
                     + sum(t.nbytes for t in k_out))
            equal = all(bit_equal(torch, a, b) for a, b in zip(k_out, p_out))
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(k_out, p_out))
            if size_name == "mlp" and "pack" in name and "unpack" not in name:
                # ties, sparse, zero and -0 windows through the packs, and
                # windows of one repeated value
                for x in (_edge_rows(torch, gen, rows),
                          torch.full((rows, PACK_BLOCK), -0.75,
                                     device=DEVICE)):
                    edge = [x] + first[1:]
                    equal = equal and all(
                        bit_equal(torch, a, b) for a, b in zip(
                            _as_tuple(kern(*edge)), _as_tuple(plain(*edge))))
            if kernel_name == "topk_unpack" and size_name == "mlp":
                # repeated, order-dependent, out-of-window and decreasing
                # indices: against the plain version on the CPU (on the
                # card its scatter_add sums repeats with atomics)
                vals, idx = _unpack_edge_packets(torch, rows,
                                                 first[0].shape[1])
                edge = [vals.to(DEVICE), idx.to(DEVICE)]
                got = kern(*edge).cpu()
                want = plain(vals, idx)
                edge_equal = bit_equal(torch, got, want)
                triple = (float(want[3, 9]), float(want[3, 4]))
                print(f"[wire-kernels] {name} edge windows rows={rows} "
                      f"bitwise={edge_equal} sums at the triples {triple} "
                      f"(slot order: (0.0, 1.0)) us_warm="
                      f"{1e3 * device_time_ms(kern, [edge], reps, inner):.3f}")
                equal = equal and edge_equal and triple == (0.0, 1.0)
                del edge, got, want
            if kernel_name == "qsgd_pack":
                # zero, one-nonzero, negative, -0.0 and subnormal windows
                edge = [_qsgd_edge_rows(torch, gen, rows)] + first[1:]
                equal = equal and all(
                    bit_equal(torch, a, b) for a, b in zip(
                        _as_tuple(kern(*edge)), _as_tuple(plain(*edge))))
            if not timed:
                table[(name, size_name)] = dict(elements=n, equal=equal,
                                                max_abs_err=err)
                print(f"[wire-kernels] {name} {size_name} rows={rows} n={n} "
                      f"bitwise={equal} max_abs_err={err} (not timed)")
                if not equal:
                    raise AssertionError(f"{name} differs from its plain "
                                         f"version at {size_name}")
                del first, k_out, p_out
                continue
            n_sets = -(-L2_FLUSH_BYTES // moved) + 1
            sets = [first] + [make(gen, rows) for _ in range(n_sets - 1)]
            row = dict(elements=n, equal=equal, max_abs_err=err,
                       bytes=moved,
                       ms=device_time_ms(kern, sets, reps, inner),
                       ms_warm=device_time_ms(kern, sets[:1], reps, inner),
                       plain_ms=device_time_ms(plain, sets, reps, inner),
                       library_ms=(device_time_ms(lib, sets, reps, inner)
                                   if lib else None),
                       library=lib_label)
            t_bytes = moved / HBM_BYTES_PER_S
            t_ops = WIRE_OPS[kernel_name] * n / F32_OPS_PER_S
            row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            table[(name, size_name)] = row
            print(f"[wire-kernels] {name} {size_name} rows={rows} n={n} "
                  f"bitwise={equal} max_abs_err={err} bytes={moved} "
                  f"us={1e3 * row['ms']:.3f} us_warm="
                  f"{1e3 * row['ms_warm']:.3f} plain_us="
                  f"{1e3 * row['plain_ms']:.3f} bound_us="
                  f"{1e3 * row['bound_ms']:.3f} ({row['bound_by']}) "
                  + (f"library_us={1e3 * row['library_ms']:.3f} "
                     f"({lib_label})" if lib else "library none"))
            if not equal:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {size_name}: max |diff| {err}")
            del sets, first, k_out, p_out
    return table


def phase_wire(torch, ops, api, data, runtime, paper, num=60000, rounds=200):
    """PORTER-GC on the full-width MLP over the bit-packed wire, both
    backends: top-k 5 % in f32 and bf16, QSGD with 7 levels in f32."""
    source, base, loss_fn = _mlp_problem(api, data, paper, num)
    wire = base.replace(wire="packed_bits", gossip_mode="packed")
    configs = {"top_k f32": wire,
               "qsgd f32": wire.replace(compressor="qsgd",
                                        compressor_kwargs={"levels": 7}),
               "top_k bf16": wire.replace(plane_dtype="bf16")}
    launches, ms_rounds = {}, {}
    for label, spec in configs.items():
        comp = label.split()[0]
        runs = {}
        for backend in ("kernel", "ref"):
            algo = _build(api, spec.replace(comm_backend=backend), loss_fn)
            state, losses, ms, counts = run_counted(
                torch, ops, runtime, algo, source, _init(algo, paper),
                rounds, 50)
            runs[backend] = (algo, state, losses, counts)
            ms_rounds[f"{label} {backend}"] = ms
            print(f"[wire] porter-gc {label} {backend} {rounds} rounds: loss "
                  f"{losses[0]:.6f} -> {losses[-1]:.6f}, {ms:.4f} ms/round, "
                  f"launches {counts}")
            if not finite(losses):
                raise AssertionError(f"wire {label} {backend}: loss is not "
                                     "finite")
        (algo, s_k, l_k, n_k), (_, s_r, _, n_r) = runs["kernel"], runs["ref"]
        same = all(bit_equal(torch, s_k.x[k], s_r.x[k]) for k in s_k.x)
        diff = max(float((s_k.x[k] - s_r.x[k]).abs().max()) for k in s_k.x)
        print(f"[wire] {label} kernel vs ref backend: x bitwise equal {same}, "
              f"max |x diff| {diff}")
        if not same:
            raise AssertionError(f"wire {label}: kernel and ref trajectories "
                                 f"differ: {diff}")
        pack, unpack = ("qsgd_pack", "qsgd_unpack") if comp == "qsgd" else (
            "topk_pack", "topk_unpack")
        want = {"ef_track": rounds, "ef_step": rounds, pack: 2 * rounds,
                unpack: 2 * rounds}
        if "bf16" in label:
            want["sr_epilogue"] = 5 * rounds
        expect_launches(f"wire {label} kernel", n_k, clip=rounds, **want)
        expect_launches(f"wire {label} ref", n_r, clip=rounds)
        launches[label] = n_k
        if comp == "top_k":
            _falls(f"wire porter-gc {label}", l_k)
        # one buffer's exchange: measured bytes, the model, and what the
        # executor's last exchange actually packed
        eng = algo.engine
        measured, model = eng.wire_bytes(s_k.x), eng.wire_bytes_model(s_k.x)
        shipped = algo.mixer.shipped_nbytes
        print(f"[wire] {label} bytes of one buffer's exchange: measured "
              f"{measured}, model {model}, packed in the last exchange "
              f"{shipped}, expected {WIRE_BYTES_MLP[comp]}")
        if not measured == model == shipped == WIRE_BYTES_MLP[comp]:
            raise AssertionError(f"wire {label}: bytes {measured} / {model} "
                                 f"/ {shipped}, expected "
                                 f"{WIRE_BYTES_MLP[comp]}")
    print(f"[wire] ms/round: {ms_rounds}")
    algo = _build(api, configs["top_k f32"].replace(comm_backend="kernel"),
                  loss_fn)
    profile_rounds(torch, runtime, algo, source, _init(algo, paper), 20,
                   "wire top_k kernel")
    return launches


# the rwkv6 serving path: the scan's shapes (B, S, H, N) and r, k, v dtype,
# the first the serving phase's (batch 4 x prompt 512, 64 heads x 64, bf16);
# then the f32 build (the consistency phase's), the long sequence, and the
# two other widths the kernel is built for (d_model 4096 split into 128
# heads x 32 and 256 x 16) in both dtypes; then, at small B and S, head
# dims padded on chip: 8 and 5 (into 16; 5 x 2 B rows are not 16-byte
# multiples, so they load element by element) and 48 (into 64).  The
# tolerance is normwise, max |kernel - plain| <= RWKV_TOL * max |plain| for
# o and for the final state: both f32 over the same factorised algorithm
# with the same sequential cumsum; the kernel forms its products on the
# tensor cores from bf16 parts of the f32 operands (16 significant bits),
# the plain version runs cuBLAS's f32 GEMMs (TF32 off).
# scan cells that move less than this are timed warm only (a cold time
# would need thousands of input sets to flush L2)
COLD_MIN_BYTES = 1 << 20
RWKV_SHAPES = {"path": ((4, 512, 64, 64), "bf16"),
               "path f32": ((4, 512, 64, 64), "f32"),
               "2x4096": ((2, 4096, 64, 64), "bf16"),
               "N=32": ((4, 512, 128, 32), "bf16"),
               "N=32 f32": ((4, 512, 128, 32), "f32"),
               "N=16": ((4, 512, 256, 16), "bf16"),
               "N=16 f32": ((4, 512, 256, 16), "f32"),
               "N=8": ((2, 64, 3, 8), "bf16"),
               "N=8 f32": ((2, 64, 3, 8), "f32"),
               "N=5": ((2, 64, 3, 5), "bf16"),
               "N=5 f32": ((2, 64, 3, 5), "f32"),
               "N=48": ((2, 128, 3, 48), "bf16"),
               "N=48 f32": ((2, 128, 3, 48), "f32")}
RWKV_TOL = 1e-4
RWKV_SERVE = dict(batch=4, prompt=512, gen=32)
# decode after a 512-token prefill against forward over 528 (the
# reference's decode-consistency tolerance)
RWKV_CONSIST = dict(layers=4, prompt=512, extra=16, tol=2e-3)


def rwkv6_flops(b, s, h, n, c) -> int:
    """The scan's arithmetic on these shapes, per (b, h) pair and chunk:
    the cumsum (C N adds); la - lw, -la, la_end - la, their three exps and
    three products (9 C N); the u bonus (3 C N); the strictly-lower rq kk^T
    and its product with v (2 N C(C-1)/2 each); bonus * v and the sum of
    the two parts (3 C N); rq S and kend^T v (2 C N^2 each); the decay's
    exps and S * decay + outer (N + 2 N^2).  An exp counts as one
    operation."""
    per = (16 * c * n + 2 * n * c * (c - 1) + 4 * c * n * n + 2 * n * n
           + n)
    return b * h * (s // c) * per


def _rwkv6_inputs(torch, gen, shape, rkv):
    """r, k, v N(0, 1) in ``rkv`` ("bf16" or "f32"); log w in [-4.9, -0.01]
    (inside the model's clamp [-5, -1e-6]); u N(0, 1) f32; s0 N(0, 1)
    f32."""
    b, s, h, n = shape
    dtype = torch.bfloat16 if rkv == "bf16" else torch.float32
    r, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
               for _ in range(3))
    logw = -(0.01 + 4.89 * torch.rand(shape, generator=gen, device=DEVICE))
    u = torch.randn(h, n, generator=gen, device=DEVICE)
    s0 = torch.randn(b, h, n, n, generator=gen, device=DEVICE)
    return [r, k, v, logw, u, s0]


def _normwise(a, b) -> tuple:
    """(max |a - b|, that over max |b|)."""
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def phase_rwkv6_kernel(torch, ops, ref, reps=10, inner=5):
    """``rwkv6_chunk`` against its plain version at each shape and r, k, v
    dtype, a state-chaining check, and its cold / warm time beside the plain
    version's and its bound (``scan_bound``: inputs read once, outputs
    written once, over HBM bandwidth, against the operations on the tensor
    cores); then N above the widest instance refused."""
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[rwkv6] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; tolerance normwise "
          f"{RWKV_TOL} (max |kernel - plain| / max |plain|)")
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    table = {}
    with torch.inference_mode():
        for name, (shape, rkv) in RWKV_SHAPES.items():
            first = _rwkv6_inputs(torch, gen, shape, rkv)
            k_out = ops.rwkv6_scan(*first)
            p_out = ref.rwkv6_chunk_ref(*first)
            torch.cuda.synchronize()
            errs = [_normwise(a, b) for a, b in zip(k_out, p_out)]
            finite = all(bool(torch.isfinite(t).all()) for t in k_out)
            # two halves with the carried state against one pass
            c = ref.RWKV_CHUNK
            half = shape[1] // 2 // c * c
            r, k, v, logw, u, s0 = first
            o1, s_mid = ops.rwkv6_scan(r[:, :half].contiguous(),
                                       k[:, :half].contiguous(),
                                       v[:, :half].contiguous(),
                                       logw[:, :half].contiguous(), u, s0)
            o2, s_end = ops.rwkv6_scan(r[:, half:].contiguous(),
                                       k[:, half:].contiguous(),
                                       v[:, half:].contiguous(),
                                       logw[:, half:].contiguous(), u,
                                       s_mid)
            chain = [_normwise(torch.cat([o1, o2], 1), k_out[0]),
                     _normwise(s_end, k_out[1])]
            moved = (sum(t.nbytes for t in first)
                     + sum(t.nbytes for t in k_out))
            cold = moved >= COLD_MIN_BYTES
            n_sets = -(-L2_FLUSH_BYTES // moved) + 1 if cold else 1
            sets = [first] + [_rwkv6_inputs(torch, gen, shape, rkv)
                              for _ in range(n_sets - 1)]
            row = dict(shape=shape, max_abs_err=max(e for e, _ in errs),
                       rel_err=max(r_ for _, r_ in errs),
                       chain_rel_err=max(r_ for _, r_ in chain),
                       bytes=moved, flops=rwkv6_flops(*shape, c),
                       ms=(device_time_ms(ops.rwkv6_scan, sets, reps, inner)
                           if cold else None),
                       ms_warm=device_time_ms(ops.rwkv6_scan, sets[:1], reps,
                                              inner),
                       plain_ms=device_time_ms(ref.rwkv6_chunk_ref, sets, 3,
                                               2),
                       library_ms=None)
            (row["bound_ms"], row["bound_by"], _, _,
             t_f32) = scan_bound(moved, row["flops"])
            row["bound_ms_f32_rate"] = 1e3 * t_f32
            row["ok"] = (finite and row["rel_err"] <= RWKV_TOL
                         and row["chain_rel_err"] <= RWKV_TOL)
            table[name] = row
            us = (f"us={1e3 * row['ms']:.3f}" if cold
                  else "us=not timed cold (fits in L2)")
            print(f"[rwkv6] kernel {name} (B, S, H, N)={shape} r/k/v {rkv}: "
                  f"max_abs_err={row['max_abs_err']} rel_err="
                  f"{row['rel_err']} (o {errs[0][1]}, state {errs[1][1]}; "
                  f"tolerance {RWKV_TOL}) chain_rel_err="
                  f"{row['chain_rel_err']} finite={finite} {us} "
                  f"us_warm={1e3 * row['ms_warm']:.3f} "
                  f"plain_us={1e3 * row['plain_ms']:.3f} "
                  f"{bound_text(moved, row['flops'])} library none")
            if not row["ok"]:
                raise AssertionError(f"rwkv6_chunk differs from its plain "
                                     f"version at {name}: {row}")
            del sets, first, k_out, p_out
        # a head dim above the widest instance: refused before any launch
        args = _rwkv6_inputs(torch, gen, (1, 16, 2, 65), "bf16")
        try:
            ops.rwkv6_scan(*args)
        except ValueError as err:
            if "queue 2 item 11" not in str(err):
                raise
            print(f"[rwkv6] N=65 refused: {err}")
        else:
            raise AssertionError("rwkv6_scan took N=65")
    return table


def _profile_call(torch, label, fn, tag="rwkv6", kernel="rwkv6_chunk"):
    """Print the device time of one call of ``fn`` by kernel name, and the
    scans' (``kernel``'s; None: no scan on the path) share of it, under
    ``torch.profiler`` (which itself slows the host side).  Returns the
    wall and device-busy µs and the kernel launches, or None when the
    profiler recorded no CUDA kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy <= 0:
        print(f"[{tag}] profile of {label}: device time not measured (the "
              "profiler recorded no CUDA kernels)")
        return None
    scans = [e for e in kernels if kernel and kernel in e.key]
    scan_us = sum(e.self_device_time_total for e in scans)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    kinds = {}
    for e in kernels:
        name = e.key.lower()
        kind = ("scans" if kernel and kernel in e.key else
                "dense products" if any(w in name for w in
                                        ("nvjet", "gemm", "cutlass")) else
                "sorts" if any(w in name for w in ("sort", "radix")) else
                "elementwise" if "elementwise" in name else
                "reductions" if "reduce" in name else
                "softmax" if "softmax" in name else "other")
        us, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (us + e.self_device_time_total, n + e.count)
    n_launch = sum(e.count for e in kernels)
    scan_text = (f"the {kernel} scans {scan_us:.1f} us x"
                 f"{sum(e.count for e in scans)} = "
                 f"{100 * scan_us / busy:.2f} % of device time; "
                 if kernel else "")
    print(f"[{tag}] profile of {label}: wall {wall_us:.1f} us under the "
          f"profiler, device busy {busy:.1f} us ({100 * busy / wall_us:.2f} "
          f"%), {n_launch} kernel launches; {scan_text}top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total:.1f} us x{e.count}"
              for e in top))
    print(f"[{tag}] profile of {label} by kind: " + "; ".join(
        f"{k} {us:.1f} us x{n} ({100 * us / busy:.2f} %)" for k, (us, n) in
        sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    return {"wall_us": wall_us, "busy_us": busy, "launches": n_launch}


def phase_rwkv6_serve(torch, ops, serve, tree_leaves):
    """rwkv6-7b at full width and depth, random parameters drawn on the
    card: serve batch 4 x prompt 512 and 32 greedy decode steps through
    ``launch.serve``; returns the kernel's launches in that run."""
    sc = RWKV_SERVE
    t0 = time.perf_counter()
    cfg, bundle, params = serve.load("rwkv6-7b", device=DEVICE, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.nbytes for t in tree_leaves(params))
    print(f"[rwkv6] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.rwkv_cfg().n_heads} heads x {cfg.ssm_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, dtype {cfg.dtype}: {n_params} "
          f"parameters drawn on {DEVICE} in "
          f"{time.perf_counter() - t0:.2f} s, {n_bytes} B resident for "
          f"serving (dense weights, lerps and embedding in {cfg.dtype})")
    tokens = serve.make_prompt(cfg, sc["batch"], sc["prompt"], DEVICE, 1)
    serve.generate(bundle, params, tokens, 2)       # warm: library set-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve.generate(bundle, params, tokens, sc["gen"])
    launches = dict(ops.LAUNCHES)
    b, s, g = sc["batch"], sc["prompt"], sc["gen"]
    ids = out["ids"]
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out["prefill_logits"], out["logits"]))
    in_range = bool(((ids >= 0) & (ids < cfg.vocab)).all())
    print(f"[rwkv6] serve batch={b} prompt={s} gen={g}: prefill "
          f"{out['prefill_s']:.4f} s = {b * s / out['prefill_s']:.1f} tok/s, "
          f"decode {out['decode_s']:.4f} s = {b * g / out['decode_s']:.1f} "
          f"tok/s ({1e3 * out['decode_s'] / g:.3f} ms/step), ids "
          f"{tuple(ids.shape)} in range {in_range}, logits finite {finite}, "
          f"peak memory {torch.cuda.max_memory_allocated()} B, launches "
          f"{launches}")
    print(f"[rwkv6] sample ids {ids[0, :16].tolist()}")
    expect_launches("rwkv6 serve", launches, rwkv6_chunk=cfg.n_layers)
    if not (finite and in_range and tuple(ids.shape) == (b, g + 1)):
        raise AssertionError(f"rwkv6 serve: finite {finite}, ids in range "
                             f"{in_range}, ids {tuple(ids.shape)}")
    with torch.inference_mode():
        _profile_call(torch, "one prefill", lambda: bundle.prefill(
            params, {"tokens": tokens}))
        tok = out["ids"][:, -1:]
        _profile_call(torch, "one decode step", lambda: bundle.decode_step(
            params, out["cache"], tok, s + g))
    return launches["rwkv6_chunk"], {
        "prefill_tok_s": b * s / out["prefill_s"],
        "decode_tok_s": b * g / out["decode_s"]}


def phase_rwkv6_consistency(torch, ops, serve):
    """Full width, 4 layers in f32: decode after a 512-token prefill
    (through the kernel) against ``forward`` over 528 tokens (through the
    kernel), step by step, and the last step against a 528-token prefill's
    last-token logits."""
    c = RWKV_CONSIST
    cfg, bundle, params = serve.load("rwkv6-7b", device=DEVICE, seed=2,
                                     dtype=torch.float32,
                                     n_layers=c["layers"])
    p, total = c["prompt"], c["prompt"] + c["extra"]
    tokens = serve.make_prompt(cfg, RWKV_SERVE["batch"], total, DEVICE, 3)
    with torch.inference_mode():
        ops.reset_launches()
        full = bundle.forward(params, {"tokens": tokens})
        last, _ = bundle.prefill(params, {"tokens": tokens})
        _, cache = bundle.prefill(params, {"tokens": tokens[:, :p]})
        launches = dict(ops.LAUNCHES)
        diffs, ok = [], True
        for i in range(p, total):
            logits, cache = bundle.decode_step(params, cache,
                                               tokens[:, i:i + 1], i)
            diffs.append(float((logits - full[:, i]).abs().max()))
            ok = ok and torch.allclose(logits, full[:, i], rtol=c["tol"],
                                       atol=c["tol"])
        last_diff = float((logits - last[:, 0]).abs().max())
        ok = ok and torch.allclose(logits, last[:, 0], rtol=c["tol"],
                                   atol=c["tol"])
    print(f"[rwkv6] consistency {cfg.n_layers} layers f32, prefill {p} then "
          f"decode tokens {p + 1}..{total}: max |decode - forward| first "
          f"step {diffs[0]}, all steps {max(diffs)}; last step against the "
          f"{total}-token prefill {last_diff} (tolerance {c['tol']}); "
          f"|logits| up to {float(full.abs().max())}; launches {launches}")
    expect_launches("rwkv6 consistency", launches,
                    rwkv6_chunk=3 * cfg.n_layers)
    if not ok:
        raise AssertionError(f"rwkv6 decode after prefill differs from "
                             f"forward: {diffs}, last {last_diff}")


# the zamba2 serving path: the SSD scan's shapes (B, S, H, P, N) and B / C
# dtype, the first the serving phase's (batch 4 x prompt 512, 112 heads x
# 64, state 64, bf16 activations); then the f32 build (the consistency
# phase's) and a long sequence; then other (P, N), each in both B / C
# dtypes: the zamba2 smoke config's (8 heads x 32, state 16), the
# reference kernel test's draws (P 8, N 16 and P 16, N 8), and P 5, N 7
# (rows that are not 16-byte multiples: the kernel's element-wise loads).
# The tolerance is normwise, max |kernel - plain| <= SSD_TOL * max |plain|
# for y and for the final state: both f32 over the same recurrence; the
# kernel forms its products on the tensor cores from bf16 parts of the
# f32 operands (16 or 24 significant bits) and passes the state between
# 16-row blocks, the plain version runs cuBLAS's f32 GEMMs (TF32 off) over
# 64-step chunks.
SSD_SHAPES = {"path": ((4, 512, 112, 64, 64), "bf16"),
              "path f32": ((4, 512, 112, 64, 64), "f32"),
              "2x4096": ((2, 4096, 112, 64, 64), "bf16"),
              "smoke": ((4, 512, 8, 32, 16), "bf16"),
              "smoke f32": ((4, 512, 8, 32, 16), "f32"),
              "P8 N16": ((2, 128, 3, 8, 16), "bf16"),
              "P8 N16 f32": ((2, 128, 3, 8, 16), "f32"),
              "P16 N8": ((1, 128, 2, 16, 8), "bf16"),
              "P16 N8 f32": ((1, 128, 2, 16, 8), "f32"),
              "P5 N7": ((1, 128, 3, 5, 7), "bf16"),
              "P5 N7 f32": ((1, 128, 3, 5, 7), "f32")}
SSD_TOL = 1e-4
ZAMBA_SERVE = dict(batch=4, prompt=512, gen=32)
# counted from src/repro/configs/zamba2_7b.py's shapes (the reference's
# jax.eval_shape of its init gives the same)
ZAMBA_PARAMS = 6_637_023_440
# decode after a 512-token prefill against forward over 576 (9 chunks of
# 64, so forward runs the kernel too), at 13 layers: 2 groups with the
# shared block and 1 trailing layer (the reference's decode-consistency
# tolerance)
ZAMBA_CONSIST = dict(layers=13, prompt=512, extra=64, tol=2e-3)
# the zamba2 smoke config (5 Mamba2 layers, 8 heads x 32, state 16): a
# 128-token prefill in its serving dtype, then in f32 a 128-token prefill
# and 64 decode steps against forward over 192 tokens (3 chunks of 64, so
# forward runs the kernel too), at the same tolerance
ZAMBA_SMOKE = dict(batch=4, prompt=128, extra=64, tol=2e-3)


def ssd_flops(b, s, h, p, n, c) -> int:
    """The SSD scan's least arithmetic on these shapes.  Per (b, chunk),
    shared by the heads: C B^T on its lower triangle (2 N T, T = C (C + 1)
    / 2 entries; the masked entries need no work).  Per (b, h, chunk): the
    cumsum (C adds); each lower entry's la_t - la_s, its exp and its
    product with C B^T (3 T); M xh on the lower triangle (2 P T); C h^T (2
    C N P), its exp(la_t) scale (C exps, C P products) and the sum of the
    two parts (C P); exp(la_end - la) (2 C) and its product with xh (C P);
    (xh kend)^T B (2 C P N); the decay's exp and h * decay + outer (1 + 2 P
    N).  An exp counts as one operation."""
    t = c * (c + 1) // 2
    per_bh = (c + 3 * t + 2 * p * t + 2 * c * n * p + c + 2 * c * p
              + 2 * c + c * p + 2 * c * p * n + 1 + 2 * p * n)
    return b * (s // c) * (2 * n * t + h * per_bh)


def _ssd_inputs(torch, gen, shape, bc):
    """xh N(0, 1) f32; B and C N(0, 1) in ``bc`` ("bf16" or "f32") as
    column slices of one (B, S, 2 N + 8) activation, as ``mamba2_block``
    passes them (the kernel reads them in place); dla in [-0.5, -0.01] (the
    reference's kernel test); h0 N(0, 1) f32."""
    b, s, h, p, n = shape
    dtype = torch.bfloat16 if bc == "bf16" else torch.float32
    xh = torch.randn(b, s, h, p, generator=gen, device=DEVICE)
    xbc = torch.randn(b, s, 2 * n + 8, generator=gen,
                      device=DEVICE).to(dtype)
    dla = -(0.01 + 0.49 * torch.rand(b, s, h, generator=gen, device=DEVICE))
    h0 = torch.randn(b, h, p, n, generator=gen, device=DEVICE)
    return [xh, xbc[..., 8:8 + n], xbc[..., 8 + n:], dla, h0]


def phase_ssd_kernel(torch, ops, ref, reps=10, inner=5):
    """``ssd_chunk`` against its plain version at each shape and B / C
    dtype, a state-chaining check, and its cold / warm time beside the
    plain version's and its bound (``scan_bound``: inputs read once,
    outputs written once, over HBM bandwidth, against the operations on
    the tensor cores); then P or N above the widest instance refused."""
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[ssd] tf32 matmul={torch.backends.cuda.matmul.allow_tf32}; "
          f"tolerance normwise {SSD_TOL} (max |kernel - plain| / max "
          "|plain|)")
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    table = {}
    with torch.inference_mode():
        for name, (shape, bc) in SSD_SHAPES.items():
            first = _ssd_inputs(torch, gen, shape, bc)
            k_out = ops.ssd_scan(*first)
            p_out = ref.ssd_chunk_ref(*first)
            torch.cuda.synchronize()
            errs = [_normwise(a, b) for a, b in zip(k_out, p_out)]
            finite = all(bool(torch.isfinite(t).all()) for t in k_out)
            # two halves with the carried state against one pass
            half = shape[1] // 2 // ref.SSD_CHUNK * ref.SSD_CHUNK
            xh, bm, cm, dla, h0 = first
            y1, h_mid = ops.ssd_scan(xh[:, :half].contiguous(), bm[:, :half],
                                     cm[:, :half], dla[:, :half].contiguous(),
                                     h0)
            y2, h_end = ops.ssd_scan(xh[:, half:].contiguous(), bm[:, half:],
                                     cm[:, half:], dla[:, half:].contiguous(),
                                     h_mid)
            chain = [_normwise(torch.cat([y1, y2], 1), k_out[0]),
                     _normwise(h_end, k_out[1])]
            # each input read once, each output written once (``nbytes``
            # of a column slice counts its own elements)
            moved = (sum(t.nbytes for t in first)
                     + sum(t.nbytes for t in k_out))
            cold = moved >= COLD_MIN_BYTES
            n_sets = -(-L2_FLUSH_BYTES // moved) + 1 if cold else 1
            sets = [first] + [_ssd_inputs(torch, gen, shape, bc)
                              for _ in range(n_sets - 1)]
            row = dict(shape=shape, max_abs_err=max(e for e, _ in errs),
                       rel_err=max(r_ for _, r_ in errs),
                       chain_rel_err=max(r_ for _, r_ in chain),
                       bytes=moved,
                       flops=ssd_flops(*shape, ref.SSD_CHUNK),
                       ms_warm=device_time_ms(ops.ssd_scan, sets[:1], reps,
                                              inner),
                       plain_ms=device_time_ms(ref.ssd_chunk_ref, sets, 3, 2),
                       library_ms=None)
            row["ms"] = (device_time_ms(ops.ssd_scan, sets, reps, inner)
                         if cold else None)
            (row["bound_ms"], row["bound_by"], _, _,
             t_f32) = scan_bound(moved, row["flops"])
            row["bound_ms_f32_rate"] = 1e3 * t_f32
            row["ok"] = (finite and row["rel_err"] <= SSD_TOL
                         and row["chain_rel_err"] <= SSD_TOL)
            table[name] = row
            us = (f"us={1e3 * row['ms']:.3f}" if cold
                  else "us=not timed cold (fits in L2)")
            print(f"[ssd] kernel {name} (B, S, H, P, N)={shape} B/C {bc}: "
                  f"max_abs_err={row['max_abs_err']} rel_err="
                  f"{row['rel_err']} (y {errs[0][1]}, state {errs[1][1]}; "
                  f"tolerance {SSD_TOL}) chain_rel_err="
                  f"{row['chain_rel_err']} finite={finite} {us} "
                  f"us_warm={1e3 * row['ms_warm']:.3f} "
                  f"plain_us={1e3 * row['plain_ms']:.3f} "
                  f"{bound_text(moved, row['flops'])} library none")
            if not row["ok"]:
                raise AssertionError(f"ssd_chunk differs from its plain "
                                     f"version at {name}: {row}")
            del sets, first, k_out, p_out
        # P or N above the widest instance: refused before any launch
        for p, n in ((65, 16), (32, 65)):
            args = _ssd_inputs(torch, gen, (1, 64, 2, p, n), "bf16")
            try:
                ops.ssd_scan(*args)
            except ValueError as err:
                if "queue 2 item 12" not in str(err):
                    raise
                print(f"[ssd] P={p} N={n} refused: {err}")
            else:
                raise AssertionError(f"ssd_scan took P={p} N={n}")
    return table


def phase_zamba2_smoke(torch, ops, serve):
    """The zamba2 smoke config on the card: a prefill in its serving dtype
    through the kernel (a launch a layer, finite logits), then in f32 a
    prefill and decode steps against ``forward`` over the longer prompt."""
    c = ZAMBA_SMOKE
    p, total = c["prompt"], c["prompt"] + c["extra"]
    with torch.inference_mode():
        cfg, bundle, params = serve.load("zamba2-7b", smoke=True,
                                         device=DEVICE, seed=6)
        tokens = serve.make_prompt(cfg, c["batch"], total, DEVICE, 7)
        ops.reset_launches()
        served, _ = bundle.prefill(params, {"tokens": tokens[:, :p]})
        torch.cuda.synchronize()
        served_launches = dict(ops.LAUNCHES)
        finite = bool(torch.isfinite(served.float()).all())
        mc = cfg.mamba_cfg()
        print(f"[zamba2] smoke {cfg.name}: {cfg.n_layers} Mamba2 layers, "
              f"{mc.n_heads} heads x {mc.head_dim}, state {mc.d_state}, "
              f"dtype {cfg.dtype}: prefill batch={c['batch']} prompt={p} "
              f"logits finite {finite}, launches {served_launches}")
        expect_launches("zamba2 smoke prefill", served_launches,
                        ssd_chunk=cfg.n_layers)
        cfg, bundle, params = serve.load("zamba2-7b", smoke=True,
                                         device=DEVICE, seed=6,
                                         dtype=torch.float32)
        ops.reset_launches()
        last, cache = bundle.prefill(params, {"tokens": tokens[:, :p]})
        launches = dict(ops.LAUNCHES)
        full = bundle.forward(params, {"tokens": tokens})
        diffs = [float((last[:, 0] - full[:, p - 1]).abs().max())]
        ok = torch.allclose(last[:, 0], full[:, p - 1], rtol=c["tol"],
                            atol=c["tol"])
        cache = serve.grow_cache(cache, c["extra"])
        for i in range(p, total):
            logits, cache = bundle.decode_step(params, cache,
                                               tokens[:, i:i + 1], i)
            diffs.append(float((logits - full[:, i]).abs().max()))
            ok = ok and torch.allclose(logits, full[:, i], rtol=c["tol"],
                                       atol=c["tol"])
    print(f"[zamba2] smoke f32: prefill {p} (launches {launches}) then "
          f"decode tokens {p + 1}..{total} against forward over {total}: "
          f"max |diff| prefill's last token {diffs[0]}, decode steps "
          f"{max(diffs[1:])} (tolerance {c['tol']})")
    expect_launches("zamba2 smoke f32 prefill", launches,
                    ssd_chunk=cfg.n_layers)
    if not (finite and ok):
        raise AssertionError(f"zamba2 smoke: finite {finite}, diffs {diffs}")


def phase_zamba2_serve(torch, ops, serve, tree_leaves):
    """zamba2-7b at full width and depth, random parameters drawn on the
    card: serve batch 4 x prompt 512 and 32 greedy decode steps through
    ``launch.serve``; returns the kernel's launches in that run and the
    rates."""
    sc = ZAMBA_SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, bundle, params = serve.load("zamba2-7b", device=DEVICE, seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.nbytes for t in tree_leaves(params))
    mc = cfg.mamba_cfg()
    print(f"[zamba2] {cfg.name}: {cfg.n_layers} Mamba2 layers, d "
          f"{cfg.d_model}, d_inner {mc.d_inner}, {mc.n_heads} heads x "
          f"{mc.head_dim}, state {mc.d_state}; the shared block "
          f"{cfg.n_layers // cfg.attn_every} times ({cfg.n_heads} heads x "
          f"{cfg.hd}, d_ff {cfg.d_ff}); vocab {cfg.vocab}, dtype {cfg.dtype}: "
          f"{n_params} parameters drawn on {DEVICE} in {load_s:.2f} s, "
          f"{n_bytes} B resident for serving (dense weights, conv and "
          f"embedding in {cfg.dtype}), peak {load_peak} B while drawing")
    if n_params != ZAMBA_PARAMS:
        raise AssertionError(f"zamba2-7b has {n_params} parameters, expected "
                             f"{ZAMBA_PARAMS}")
    tokens = serve.make_prompt(cfg, sc["batch"], sc["prompt"], DEVICE, 1)
    serve.generate(bundle, params, tokens, 2)       # warm: library set-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve.generate(bundle, params, tokens, sc["gen"])
    launches = dict(ops.LAUNCHES)
    b, s, g = sc["batch"], sc["prompt"], sc["gen"]
    ids = out["ids"]
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out["prefill_logits"], out["logits"]))
    in_range = bool(((ids >= 0) & (ids < cfg.vocab)).all())
    peak = torch.cuda.max_memory_allocated()
    print(f"[zamba2] serve batch={b} prompt={s} gen={g}: prefill "
          f"{out['prefill_s']:.4f} s = {b * s / out['prefill_s']:.1f} tok/s, "
          f"decode {out['decode_s']:.4f} s = {b * g / out['decode_s']:.1f} "
          f"tok/s ({1e3 * out['decode_s'] / g:.3f} ms/step), ids "
          f"{tuple(ids.shape)} in range {in_range}, logits finite {finite}, "
          f"peak memory {peak} B, launches {launches}")
    print(f"[zamba2] sample ids {ids[0, :16].tolist()}")
    expect_launches("zamba2 serve", launches, ssd_chunk=cfg.n_layers)
    if not (finite and in_range and tuple(ids.shape) == (b, g + 1)):
        raise AssertionError(f"zamba2 serve: finite {finite}, ids in range "
                             f"{in_range}, ids {tuple(ids.shape)}")
    with torch.inference_mode():
        _profile_call(torch, "one prefill", lambda: bundle.prefill(
            params, {"tokens": tokens}), "zamba2", "ssd_chunk")
        # one more step at the last slot of the grown cache (rewritten in
        # place); a decode step runs the recurrence, never the kernel
        ops.reset_launches()
        _profile_call(torch, "one decode step", lambda: bundle.decode_step(
            params, out["cache"], ids[:, -1:], s + g - 1), "zamba2",
            "ssd_chunk")
        expect_launches("zamba2 decode step", dict(ops.LAUNCHES))
    return launches["ssd_chunk"], {
        "prefill_tok_s": b * s / out["prefill_s"],
        "decode_tok_s": b * g / out["decode_s"], "peak_bytes": peak,
        "resident_bytes": n_bytes, "params": n_params}


def phase_zamba2_consistency(torch, ops, serve):
    """Full width, 13 layers in f32 (2 groups with the shared block, 1
    trailing layer): decode after a 512-token prefill (through the kernel)
    against ``forward`` over 576 tokens (through the kernel), step by step,
    and the last step against a 576-token prefill's last-token logits."""
    c = ZAMBA_CONSIST
    torch.cuda.reset_peak_memory_stats()
    cfg, bundle, params = serve.load("zamba2-7b", device=DEVICE, seed=2,
                                     dtype=torch.float32,
                                     n_layers=c["layers"])
    p, total = c["prompt"], c["prompt"] + c["extra"]
    tokens = serve.make_prompt(cfg, ZAMBA_SERVE["batch"], total, DEVICE, 3)
    with torch.inference_mode():
        ops.reset_launches()
        full = bundle.forward(params, {"tokens": tokens})
        last, _ = bundle.prefill(params, {"tokens": tokens})
        _, cache = bundle.prefill(params, {"tokens": tokens[:, :p]})
        launches = dict(ops.LAUNCHES)
        cache = serve.grow_cache(cache, c["extra"])
        diffs, ok = [], True
        for i in range(p, total):
            logits, cache = bundle.decode_step(params, cache,
                                               tokens[:, i:i + 1], i)
            diffs.append(float((logits - full[:, i]).abs().max()))
            ok = ok and torch.allclose(logits, full[:, i], rtol=c["tol"],
                                       atol=c["tol"])
        last_diff = float((logits - last[:, 0]).abs().max())
        ok = ok and torch.allclose(logits, last[:, 0], rtol=c["tol"],
                                   atol=c["tol"])
    print(f"[zamba2] consistency {cfg.n_layers} layers f32 "
          f"({cfg.n_layers // cfg.attn_every} shared-block applications), "
          f"prefill {p} then decode tokens {p + 1}..{total}: max |decode - "
          f"forward| first step {diffs[0]}, all steps {max(diffs)}; last "
          f"step against the {total}-token prefill {last_diff} (tolerance "
          f"{c['tol']}); |logits| up to {float(full.abs().max())}; launches "
          f"{launches}; peak memory {torch.cuda.max_memory_allocated()} B")
    expect_launches("zamba2 consistency", launches,
                    ssd_chunk=3 * cfg.n_layers)
    if not ok:
        raise AssertionError(f"zamba2 decode after prefill differs from "
                             f"forward: {diffs}, last {last_diff}")


# phase 8: the last four kernels.  The clip planes, as (rows, tiles a row):
# the MLP's agent plane (10 agents x 7 tiles: what PORTER-GC, CHOCO and
# DSGD clip each round), the quickstart's (10 agents x 1 tile),
# PORTER-DP's per-sample plane (10 agents x 8 samples), the DP
# perturbation's (the MLP's 10-agent gradient as one row of 63 tiles, at
# factor 1: :func:`_perturb`, which the DP algorithms ran until
# ``mean_noise`` took its place), and 2^24 elements as 1 row and as 16.
CLIP_PLANES = {"mlp": (10, 7), "quickstart": (10, 1), "dp": (80, 7),
               "dp noise": (1, 63), "2^24 x1": (1, 2048),
               "2^24 x16": (16, 128)}
UNIT_FACTOR_PLANES = ("dp noise",)
CLIP_KERNELS = {"sumsq": "src/repro/kernels/smooth_clip.py:41",
                "scale": "src/repro/kernels/smooth_clip.py:69",
                "scale_noise": "src/repro/kernels/smooth_clip.py:77"}
# per element, the operations on the inputs, counted at the f32 rate:
# sumsq's square and add, scale's product, scale_noise's two products and
# an add
CLIP_OPS = {"sumsq": 2, "scale": 1, "scale_noise": 3}
# block_topk: windows and k at each size; "w1" is the MLP's w1 gradient
# (10 agents x 25 windows), "edge" small-integer ties, sparse, all-zero
# and -0.0 windows (``_edge_rows``), "2^24" Gaussian windows
TOPK_CELLS = {"w1": (250, (1, 102, 512, 2048)),
              "edge": (250, (1, 102, 512, 2048)),
              "2^24": (8192, (102,))}
# per element: the key mask, at most four digit passes of the radix select
# (the prefix compare, the digit and its count: 3 operations each), the
# tie compare and the select, counted at the f32 rate
TOPK_OPS = 1 + 4 * 3 + 2
TOPK_REPLACES = "src/repro/kernels/block_topk.py:54"
DTYPES = ("f32", "bf16")


def _dtype(torch, name):
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


def _clip_variants(torch, ops, ref, rows):
    """Per clip kernel: (kernel, plain version, the PyTorch calls timed
    beside it as (label, call, whether it computes the kernel's function
    in f32)).  Each takes (plane, factor, noise)."""
    def vecdot(p, f, z):
        return torch.linalg.vecdot(p, p, dim=1)

    def norm(p, f, z):
        return torch.linalg.vector_norm(p.view(rows, -1), dim=1,
                                         dtype=torch.float32)

    def mul(p, f, z):
        return torch.mul(p.view(rows, -1), f[:, None])

    def add(p, f, z):
        return torch.add(p.view(rows, -1) * f[:, None], z.view(rows, -1),
                         alpha=DP_SIGMA)

    return {
        "sumsq": (lambda p, f, z: ops.clip_sumsq(p),
                  lambda p, f, z: ref.clip_sumsq(p),
                  [("torch.linalg.vecdot(p, p, dim=1): a tile's sum of "
                    "squares", vecdot, True),
                   ("nearest: torch.linalg.vector_norm(dim=1), the norm a "
                    "row", norm, False)]),
        "scale": (lambda p, f, z: ops.clip_scale(p, f),
                  lambda p, f, z: ref.clip_scale_ref(p, f),
                  [("torch.mul broadcast over the rows", mul, True)]),
        "scale_noise": (lambda p, f, z: ops.clip_scale(p, f, z, DP_SIGMA),
                        lambda p, f, z: ref.clip_scale_ref(p, f, z,
                                                           DP_SIGMA),
                        [("nearest: torch.add(x * f, z, alpha=sigma), two "
                          "calls", add, False)])}


def _clip_bytes(name, plane, rows):
    """Bytes the kernel must move: each input read once, each output
    written once."""
    n, tiles = plane.nbytes, plane.shape[0]
    return {"sumsq": n + 4 * tiles, "scale": 2 * n + 4 * rows,
            "scale_noise": 3 * n + 4 * rows}[name]


def phase_clip_kernels(torch, ops, ref, reps=20, inner=10):
    """``sumsq``, ``scale`` and ``scale_noise`` against their plain versions,
    bitwise, at every clip plane in f32 and bf16 (the perturbation's plane
    at factor 1 and the path's sigma), timed cold / warm beside their bound
    and the PyTorch calls for the same function (in f32) or the nearest."""
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    table = {}
    for size, (rows, tiles) in CLIP_PLANES.items():
        for dt in DTYPES:
            def make():
                p = (3 * torch.randn(rows * tiles, TILE, generator=gen,
                                     device=DEVICE)).to(_dtype(torch, dt))
                z = torch.randn(p.shape, generator=gen, device=DEVICE).to(
                    p.dtype)
                f = (torch.ones(rows, device=DEVICE)
                     if size in UNIT_FACTOR_PLANES else
                     torch.rand(rows, generator=gen, device=DEVICE))
                return [p, f, z]
            first = make()
            n_sets = -(-L2_FLUSH_BYTES // (3 * first[0].nbytes)) + 1
            sets = [first] + [make() for _ in range(n_sets - 1)]
            for name, (kern, plain, calls) in _clip_variants(
                    torch, ops, ref, rows).items():
                k_out, p_out = kern(*first), plain(*first)
                torch.cuda.synchronize()
                equal = bit_equal(torch, k_out, p_out)
                err = float((k_out.float() - p_out.float()).abs().max())
                moved = _clip_bytes(name, first[0], rows)
                n = rows * tiles * TILE
                row = dict(elements=n, rows=rows, equal=equal,
                           max_abs_err=err, bytes=moved,
                           ms=device_time_ms(kern, sets, reps, inner),
                           ms_warm=device_time_ms(kern, sets[:1], reps,
                                                  inner),
                           plain_ms=device_time_ms(plain, sets, reps, inner),
                           library_ms=None, nearest_ms=None)
                t_bytes = moved / HBM_BYTES_PER_S
                t_ops = CLIP_OPS[name] * n / F32_OPS_PER_S
                row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
                row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                timed = []
                for label, call, same in calls:
                    ms = device_time_ms(call, sets, reps, inner)
                    same = same and dt == "f32"
                    key = "library_ms" if same else "nearest_ms"
                    if row[key] is None:
                        row[key] = ms
                    timed.append(f"{'torch' if same else 'nearest'}_us="
                                 f"{1e3 * ms:.3f} ({label})")
                table[(name, size, dt)] = row
                print(f"[clip] {name} {size} rows={rows} tiles/row={tiles} "
                      f"{dt} n={n} bitwise={equal} max_abs_err={err} "
                      f"bytes={moved} us={1e3 * row['ms']:.3f} us_warm="
                      f"{1e3 * row['ms_warm']:.3f} plain_us="
                      f"{1e3 * row['plain_ms']:.3f} bound_us="
                      f"{1e3 * row['bound_ms']:.3f} ({row['bound_by']}) "
                      + " ".join(timed))
                if not equal:
                    raise AssertionError(f"{name} differs from its plain "
                                         f"version at {size} {dt}: {err}")
            del sets, first
    return table


# the fused clip: taus held bitwise on every plane, the plane the noise
# form is held on, and the one a CUDA graph captures
CLIP_TAUS = (0.3, 1.0, 4.0)
CLIP_NOISE_PLANE = "mlp"
CLIP_GRAPH_PLANE = "mlp"
CLIP_REPLACES = ("src/repro/kernels/smooth_clip.py:41 (sumsq), "
                 "src/repro/kernels/smooth_clip.py:69 (scale) and the jnp "
                 "combine between them, src/repro/kernels/ops.py:59-61")
# per element: sumsq's square and add, and the product of the scale
CLIP_FUSED_OPS = 3


def phase_clip_fused(torch, ops, ref, sc, reps=20, inner=10):
    """The fused ``clip`` kernel (``ops.clip_planes``) against its plain
    composition (``ref.clip_planes_ref``: ``clip_sumsq``,
    ``smooth_factors``, ``clip_scale_ref``), bitwise with its partials and
    factors, at every clip plane in f32 and bf16 and tau 0.3, 1 and 4, and
    in its noise form on the MLP's plane; timed cold / warm beside its
    bound (the function's bytes: the plane read once, the clip, the
    partials and the factors written once), the composition of wrapper
    calls it stands for (``sumsq`` + this tree's ``smooth_factors`` +
    ``scale``, timed with ``cover``; the route as the parent ran it is
    ``tools/kernel_ab.py --only clip``'s) and the two kernels alone.  Then
    one ``clip_planes`` call captured in a CUDA graph and replayed, bitwise
    the eager call.  Returns {(plane, dtype): row}."""
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    table = {}
    for size, (rows, tiles) in CLIP_PLANES.items():
        for dt in DTYPES:
            def make():
                p = (3 * torch.randn(rows * tiles, TILE, generator=gen,
                                     device=DEVICE)).to(_dtype(torch, dt))
                z = torch.randn(p.shape, generator=gen, device=DEVICE).to(
                    p.dtype)
                f = torch.rand(rows, generator=gen, device=DEVICE)
                return [p, f, z]
            first = make()
            n_sets = -(-L2_FLUSH_BYTES // (2 * first[0].nbytes)) + 1
            sets = [first] + [make() for _ in range(n_sets - 1)]
            p, f, z = first
            checks = [(tau, None) for tau in CLIP_TAUS]
            if size == CLIP_NOISE_PLANE:
                checks.append((1.0, z))
            equal, errs = True, []
            for tau, noise in checks:
                got = ops.clip_planes(p, rows, tau, noise, DP_SIGMA)
                want = ref.clip_planes_ref(p, rows, tau, noise, DP_SIGMA)
                torch.cuda.synchronize()
                same = [bit_equal(torch, g, w) for g, w in zip(got, want)]
                equal = equal and all(same)
                errs.append(float((got[0].float() - want[0].float())
                                  .abs().max()))
                if not all(same):
                    raise AssertionError(
                        f"fused clip differs from its plain composition at "
                        f"{size} {dt} tau={tau} noise={noise is not None}: "
                        f"(clip, partials, factors) bitwise {same}")
            plan = sc.clip_plan(p, rows)
            n = rows * tiles * TILE
            moved = 2 * p.nbytes + 4 * rows * tiles + 4 * rows
            t_bytes = moved / HBM_BYTES_PER_S
            t_ops = CLIP_FUSED_OPS * n / F32_OPS_PER_S

            def fused(p, f, z):
                return ops.clip_planes(p, rows, 1.0)

            def route(p, f, z):
                return ops.clip_scale(p, ops.smooth_factors(
                    ops.clip_sumsq(p), rows, 1.0))

            def pair(p, f, z):
                return ops.clip_sumsq(p), ops.clip_scale(p, f)

            row = dict(elements=n, rows=rows, equal=equal,
                       max_abs_err=max(errs), bytes=moved, plan=plan,
                       ms=device_time_ms(fused, sets, reps, inner),
                       ms_warm=device_time_ms(fused, sets[:1], reps, inner),
                       route_ms=device_time_ms(route, sets, reps, inner,
                                               cover=True),
                       pair_ms=device_time_ms(pair, sets, reps, inner,
                                              cover=True),
                       plain_ms=device_time_ms(
                           lambda p, f, z: ref.clip_planes_ref(p, rows, 1.0),
                           sets, reps, inner),
                       bound_ms=1e3 * max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       # the cooperative route reads the plane twice
                       floor_ms=1e3 * (moved + p.nbytes) / HBM_BYTES_PER_S)
            table[(size, dt)] = row
            print(f"[clip] fused {size} rows={rows} tiles/row={tiles} {dt} "
                  f"n={n} taus={list(CLIP_TAUS)}"
                  f"{' +noise' if size == CLIP_NOISE_PLANE else ''} "
                  f"bitwise (clip, partials, factors)={equal} "
                  f"max_abs_err={row['max_abs_err']} route={plan['route']} "
                  f"grid={plan['grid']} tiles/cta={plan['tiles_per_cta']} "
                  f"bytes={moved} "
                  f"us={1e3 * row['ms']:.3f} us_warm="
                  f"{1e3 * row['ms_warm']:.3f} sumsq+smooth_factors+scale_us="
                  f"{1e3 * row['route_ms']:.3f} sumsq+scale_us="
                  f"{1e3 * row['pair_ms']:.3f} plain_us="
                  f"{1e3 * row['plain_ms']:.3f} bound_us="
                  f"{1e3 * row['bound_ms']:.3f} ({row['bound_by']}) "
                  f"two_reads_us={1e3 * row['floor_ms']:.3f}")
            del sets, first, p, f, z
    # one clip in a CUDA graph: the cooperative launch captured and replayed
    rows, tiles = CLIP_PLANES[CLIP_GRAPH_PLANE]
    p = torch.randn(rows * tiles, TILE, generator=gen, device=DEVICE)
    eager = ops.clip_planes(p, rows, 0.3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.clip_planes(p, rows, 0.3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.clip_planes(p, rows, 0.3)
    graph.replay()
    torch.cuda.synchronize()
    same = [bit_equal(torch, g, w) for g, w in zip(captured, eager)]
    replay_ms = device_time_ms(graph.replay, [()], reps, inner)
    print(f"[clip] graph {CLIP_GRAPH_PLANE} rows={rows} tiles/row={tiles} "
          f"f32: one clip_planes captured in a CUDA graph and replayed, "
          f"bitwise the eager call (clip, partials, factors)={same}, "
          f"replay_us={1e3 * replay_ms:.3f}")
    if not all(same):
        raise AssertionError(f"the graph replay of clip_planes differs from "
                             f"the eager call: {same}")
    table["graph"] = dict(equal=True, ms=replay_ms)
    return table


# mean_noise, the DP perturbation of the clipped samples' mean: the path's
# plane is the MLP's real per-sample gradients (10 agents x 8 samples x 7
# tiles), clipped; the synthetic planes are (groups, b) at the MLP's 7
# tiles a row, one group (DP-SGD's single model) and ten (the agents)
MEAN_GROUPS = (1, 10)
MEAN_B = (1, 3, 8, 32)
MEAN_TILES = 7
# a kernel of the port alone: the reference takes the sample mean and adds
# the noise in plain jnp (src/repro/core/clipping.py:101-104,
# src/repro/core/porter.py:137-145, src/repro/core/baselines.py:65-74), so
# no TPU kernel; it replaces the port's own eager route (a sum and a / b a
# leaf, the re-pack, ones, scale_noise)
MEAN_REPLACES = None
MEAN_PATH = "mlp real"
# per output element: b adds, the product with RN(1 / b), sigma * z and
# the add; counted at the f32 rate beside b
MEAN_EXTRA_OPS = 3


def _perturb(torch, ops, flatten, tree, noise, sigma):
    """``g + sigma * z`` leaf by leaf through ``scale_noise`` at factor 1,
    the whole tree one row (the DP perturbation before ``mean_noise``)."""
    spec = flatten.flat_spec(tree, stacked=False)
    planes = flatten.to_planes(tree, spec)
    one = torch.ones(1, dtype=torch.float32, device=planes.device)
    return flatten.from_planes(ops.clip_scale(
        planes, one, flatten.to_planes(noise, spec), sigma), spec)


def _mean_noise_cells(torch, ops, gen, flatten, clipping, api, data, paper):
    """{(cell, dtype): (groups, b, make)}, ``make()`` giving a fresh input
    set [clipped plane, noise plane, clipped per-sample tree or None, noise
    tree or None, the per-sample spec or None].  The real cells clip the
    MLP's per-sample gradients of one minibatch (``ops.clip_planes``, tau
    1) and copy that plane for each set; the synthetic ones draw Gaussian
    samples with a tenth of them -0.0."""
    source, base, loss_fn = _mlp_problem(api, data, paper, 60000)
    params = paper.mlp_init(seed=0, device=DEVICE)
    x = {k: v.unsqueeze(0).expand((10,) + tuple(v.shape)).clone()
         for k, v in params.items()}
    batch = source(torch.Generator(device=DEVICE).manual_seed(9), 0)
    rows, losses = clipping.per_sample_grads(loss_fn, x, batch, "stacked")
    groups, b = losses.shape
    cells = {}
    for dt in DTYPES:
        tree = {k: v.to(_dtype(torch, dt)) for k, v in rows.items()}
        spec = flatten.flat_spec(tree)
        clipped = ops.clip_planes(flatten.to_planes(tree, spec), spec.rows,
                                  1.0)[0]
        mean = spec._replace(rows=groups, plane_dtype=torch.float32)

        def make(clipped=clipped, spec=spec, mean=mean):
            plane = clipped.clone()
            ztree = {k: torch.randn((groups,) + shape, generator=gen,
                                    device=DEVICE, dtype=dtype)
                     for k, shape, dtype in zip(
                         sorted(rows), spec.shapes, spec.dtypes)}
            return [plane, flatten.to_planes(ztree, mean),
                    flatten.from_planes(plane, spec), ztree, spec]
        cells[(MEAN_PATH, dt)] = (groups, b, make)
    for g in MEAN_GROUPS:
        for b in MEAN_B:
            for dt in DTYPES:
                def make(g=g, b=b, dt=dt):
                    p = torch.randn(g * b * MEAN_TILES, TILE, generator=gen,
                                    device=DEVICE)
                    p[torch.rand(p.shape, generator=gen, device=DEVICE)
                      < 0.1] = -0.0
                    z = torch.randn(g * MEAN_TILES, TILE, generator=gen,
                                    device=DEVICE)
                    return [p.to(_dtype(torch, dt)), z, None, None, None]
                cells[(f"{g} x {b} x {MEAN_TILES}", dt)] = (g, b, make)
    return cells


def phase_mean_noise(torch, ops, ref, api, data, paper, flatten, clipping,
                     reps=20, inner=10):
    """``mean_noise`` (``ops.dp_mean_noise``) against its plain version
    ``ref.dp_mean_noise_ref``, bitwise, with the noise and without it (the
    mean alone), on the MLP's real clipped per-sample plane and on the
    synthetic planes, f32 and bf16; timed cold
    / warm beside its bound (the samples and the noise read once, the f32
    mean written once), the plain version, the PyTorch call for the same
    function where the samples are f32 (``torch.baddbmm(z, ones, x,
    beta=sigma, alpha=1 / b)``: a batched product of a row of ones with
    each group's samples) and the nearest PyTorch calls
    (``torch.add(x.mean(1), z, alpha=sigma)``).  On the real planes also
    the eager route it replaced, from the clipped per-sample tree to the
    perturbed plane (a ``sum`` and a ``/ b`` a leaf, the re-pack of the
    mean and of the noise, ``ones``, ``scale_noise``), and the whole DP
    route from the clipped plane and the noise tree to the perturbed tree,
    as this tree runs it (the noise packed, ``mean_noise``, the unpack)
    and as the parent ran it (the unpack of the clipped plane, then that
    eager route and its unpack); each several wrapper calls, so timed with
    ``cover``.  Returns {(cell, dtype): row}."""
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    one = torch.ones(1, dtype=torch.float32, device=DEVICE)
    table = {}
    for (cell, dt), (groups, b, make) in _mean_noise_cells(
            torch, ops, gen, flatten, clipping, api, data, paper).items():
        first = make()
        x, z = first[0], first[1]
        moved = x.nbytes + 2 * z.nbytes
        n_sets = -(-L2_FLUSH_BYTES // moved) + 1
        sets = [first] + [make() for _ in range(n_sets - 1)]
        got = ops.dp_mean_noise(x, groups, b, z, DP_SIGMA)
        want = ref.dp_mean_noise_ref(x, groups, b, z, DP_SIGMA)
        # the mean alone (no noise plane: clipped_grad_accumulate's form)
        got_mean = ops.dp_mean_noise(x, groups, b)
        want_mean = ref.dp_mean_noise_ref(x, groups, b)
        torch.cuda.synchronize()
        equal_mean = bit_equal(torch, got_mean, want_mean)
        equal = bit_equal(torch, got, want) and equal_mean
        err = max(float((got - want).abs().max()),
                  float((got_mean - want_mean).abs().max()))

        def kern(p, z, *rest):
            return ops.dp_mean_noise(p, groups, b, z, DP_SIGMA)

        def plain(p, z, *rest):
            return ref.dp_mean_noise_ref(p, groups, b, z, DP_SIGMA)

        def nearest(p, z, *rest):
            mean = p.view(groups, b, -1).mean(1, dtype=torch.float32)
            return torch.add(mean, z.view(groups, -1), alpha=DP_SIGMA)

        ones = torch.ones(groups, 1, b, dtype=torch.float32, device=DEVICE)

        def library(p, z, *rest):
            return torch.baddbmm(z.view(groups, 1, -1), ones,
                                 p.view(groups, b, -1), beta=DP_SIGMA,
                                 alpha=1.0 / b)

        out_n = z.numel()
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = (b + MEAN_EXTRA_OPS) * out_n / F32_OPS_PER_S
        row = dict(groups=groups, b=b, tiles=x.shape[0] // (groups * b),
                   equal=equal, max_abs_err=err, bytes=moved,
                   ms=device_time_ms(kern, sets, reps, inner),
                   ms_warm=device_time_ms(kern, sets[:1], reps, inner),
                   plain_ms=device_time_ms(plain, sets, reps, inner),
                   nearest_ms=device_time_ms(nearest, sets, reps, inner),
                   library_ms=(device_time_ms(library, sets, reps, inner)
                               if dt == "f32" else None),
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        routes = ""
        if first[2] is not None:
            spec = first[4]
            mean = spec._replace(rows=groups, plane_dtype=torch.float32)

            def leaf_means(ctree):
                return {k: a.view((groups, b) + tuple(a.shape[1:])).sum(1)
                        / b for k, a in ctree.items()}

            def replaced(p, zp, ctree, ztree, spec):
                m = leaf_means(ctree)
                sp = flatten.flat_spec(m, stacked=False)
                return ops.clip_scale(flatten.to_planes(m, sp), one,
                                      flatten.to_planes(ztree, sp), DP_SIGMA)

            def this_route(p, zp, ctree, ztree, spec):
                return flatten.from_planes(ops.dp_mean_noise(
                    p, groups, b, flatten.to_planes(ztree, mean), DP_SIGMA),
                    mean)

            def parent_route(p, zp, ctree, ztree, spec):
                m = leaf_means(flatten.from_planes(p, spec))
                return _perturb(torch, ops, flatten, m, ztree, DP_SIGMA)

            row.update(
                replaced_route_ms=device_time_ms(replaced, sets, reps, inner,
                                                 cover=True),
                route_ms=device_time_ms(this_route, sets, reps, inner,
                                        cover=True),
                parent_route_ms=device_time_ms(parent_route, sets, reps,
                                               inner, cover=True))
            routes = (f" replaced_route_us="
                      f"{1e3 * row['replaced_route_ms']:.3f}"
                      f" (sum, / b, re-pack, ones, scale_noise) dp_route_us="
                      f"{1e3 * row['route_ms']:.3f} (noise pack, mean_noise, "
                      f"unpack) parent_dp_route_us="
                      f"{1e3 * row['parent_route_ms']:.3f} (unpack, sum, / b, "
                      f"perturb)")
        if row["library_ms"] is not None:
            routes = (f" library_us={1e3 * row['library_ms']:.3f} "
                      f"(torch.baddbmm)" + routes)
        table[(cell, dt)] = row
        print(f"[mean_noise] {cell} {dt} groups={groups} b={b} "
              f"tiles/row={row['tiles']} sigma={DP_SIGMA} bitwise={equal} "
              f"(mean alone bitwise={equal_mean}) "
              f"max_abs_err={err} bytes={moved} us={1e3 * row['ms']:.3f} "
              f"us_warm={1e3 * row['ms_warm']:.3f} plain_us="
              f"{1e3 * row['plain_ms']:.3f} bound_us="
              f"{1e3 * row['bound_ms']:.3f} ({row['bound_by']}) nearest_us="
              f"{1e3 * row['nearest_ms']:.3f} (torch.add(x.mean(1), z, "
              f"alpha=sigma), two calls)" + routes)
        if not equal:
            raise AssertionError(f"mean_noise differs from its plain version "
                                 f"at {cell} {dt}: {err}")
        del sets, first, x, z, got, want, got_mean, want_mean
    return table


def phase_clip_gradient(torch, ops, ref, api, data, paper, flatten,
                        clipping):
    """The row-stacked clip of one real MLP gradient (10 agents at full
    width, one minibatch) through the kernels, bitwise against the plain
    composition on the same CUDA tensors, its DP perturbation (the whole
    tree as one row of 63 tiles, factor 1) bitwise against ``g + sigma *
    z`` leaf by leaf, and the DP gradient of the same minibatch
    (``clipping.dp_gradient``: the per-sample clip, then ``mean_noise``)
    bitwise against ``ref.clip_planes_ref`` then ``ref.dp_mean_noise_ref``;
    returns the gradient."""
    from torch.func import grad_and_value, vmap
    source, base, loss_fn = _mlp_problem(api, data, paper, 60000)
    params = paper.mlp_init(seed=0, device=DEVICE)
    x = {k: v.unsqueeze(0).expand((10,) + tuple(v.shape)).clone()
         for k, v in params.items()}
    batch = source(torch.Generator(device=DEVICE).manual_seed(9), 0)
    g, _ = vmap(grad_and_value(loss_fn))(x, batch)
    for dt in DTYPES:
        gt = {k: v.to(_dtype(torch, dt)) for k, v in g.items()}
        ops.reset_launches()
        got = clipping.stacked_clip(gt, 1.0)
        launches = dict(ops.LAUNCHES)
        spec = flatten.flat_spec(gt)
        planes = flatten.to_planes(gt, spec)
        factor = ops.smooth_factors(ref.clip_sumsq(planes), spec.rows, 1.0)
        want = flatten.from_planes(ref.clip_scale_ref(planes, factor), spec)
        torch.cuda.synchronize()
        same = all(bit_equal(torch, got[k], want[k]) for k in g)
        norms = torch.sqrt(ref.clip_sumsq(planes).view(10, -1).sum(1))
        print(f"[clip] row-stacked clip of the MLP gradient ({dt}, 10 "
              f"agents, {spec.d} elements each, plane "
              f"{tuple(planes.shape)}): bitwise equal to the plain "
              f"composition {same}; row norms "
              f"{[round(float(v), 6) for v in norms]}; launches {launches}")
        expect_launches(f"clip gradient {dt}", launches, clip=1)
        if not same:
            raise AssertionError(f"row-stacked clip differs ({dt})")
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    z = {k: torch.randn(v.shape, generator=gen, device=DEVICE)
         for k, v in g.items()}
    ops.reset_launches()
    got = _perturb(torch, ops, flatten, g, z, DP_SIGMA)
    launches = dict(ops.LAUNCHES)
    want = {k: g[k] + DP_SIGMA * z[k] for k in g}
    torch.cuda.synchronize()
    same = all(bit_equal(torch, got[k], want[k]) for k in g)
    spec = flatten.flat_spec(g, stacked=False)
    print(f"[clip] DP perturbation of the MLP gradient (plane "
          f"{spec.plane_shape}, sigma {DP_SIGMA}): bitwise equal to g + "
          f"sigma * z {same}; launches {launches}")
    expect_launches("clip perturbation", launches, scale_noise=1)
    if not same:
        raise AssertionError("DP perturbation differs from g + sigma * z")
    # the DP gradient of PORTER-DP's round: every sample's gradient clipped,
    # then each agent's mean and its noise, against the plain clip and
    # mean on the same CUDA tensors
    rows, losses = clipping.per_sample_grads(loss_fn, x, batch, "stacked")
    groups, b = losses.shape
    ops.reset_launches()
    got, _ = clipping.dp_gradient(loss_fn, x, batch, 1.0, DP_SIGMA, noise=z,
                                  agents="stacked")
    launches = dict(ops.LAUNCHES)
    spec = flatten.flat_spec(rows)
    mean = spec._replace(rows=groups, plane_dtype=torch.float32)
    clipped = ref.clip_planes_ref(flatten.to_planes(rows, spec), spec.rows,
                                  1.0)[0]
    want = flatten.from_planes(ref.dp_mean_noise_ref(
        clipped, groups, b, flatten.to_planes(z, mean), DP_SIGMA), mean)
    torch.cuda.synchronize()
    same = all(bit_equal(torch, got[k], want[k]) for k in g)
    print(f"[clip] DP gradient of the MLP ({groups} agents x {b} samples, "
          f"per-sample plane {tuple(clipped.shape)}, sigma {DP_SIGMA}): "
          f"bitwise equal to the plain clip, sample mean and noise {same}; "
          f"launches {launches}")
    expect_launches("clip dp gradient", launches, clip=1, mean_noise=1)
    if not same:
        raise AssertionError("DP gradient differs from the plain clip and "
                             "dp_mean_noise_ref")
    return g


def phase_clip_trajectory(torch, ops, ref, api, data, runtime, paper,
                          num=60000, rounds=50):
    """PORTER-GC and PORTER-DP on the full-width MLP (f32, kernel backend)
    twice from one seed: with the clip through the kernels (the fused
    ``clip``, and ``mean_noise`` for the DP sample mean and noise), then
    with ``ops.clip_planes``, ``ops.clip_sumsq``, ``ops.clip_scale`` and
    ``ops.dp_mean_noise`` swapped for their plain versions on the same
    CUDA tensors.  x must agree bitwise, and the plain run must launch no
    clip kernel."""
    source, base, loss_fn = _mlp_problem(api, data, paper, num)
    for name, over in (("porter-gc", {}),
                       ("porter-dp", dict(algo="porter-dp",
                                          sigma_p=DP_SIGMA))):
        algo = _build(api, base.replace(**over), loss_fn)

        def run():
            return run_counted(torch, ops, runtime, algo, source,
                               _init(algo, paper), rounds, rounds // 2)

        s_k, l_k, ms_k, n_k = run()
        saved = (ops.clip_planes, ops.clip_sumsq, ops.clip_scale,
                 ops.dp_mean_noise)
        (ops.clip_planes, ops.clip_sumsq, ops.clip_scale,
         ops.dp_mean_noise) = (ref.clip_planes_ref, ref.clip_sumsq,
                               ref.clip_scale_ref, ref.dp_mean_noise_ref)
        try:
            s_p, l_p, ms_p, n_p = run()
        finally:
            (ops.clip_planes, ops.clip_sumsq, ops.clip_scale,
             ops.dp_mean_noise) = saved
        same = all(bit_equal(torch, s_k.x[k], s_p.x[k]) for k in s_k.x)
        diff = max(float((s_k.x[k] - s_p.x[k]).abs().max()) for k in s_k.x)
        print(f"[clip] {name} {rounds} rounds, clip kernels vs plain clip: "
              f"x bitwise equal {same}, max |x diff| {diff}, loss "
              f"{l_k[-1]:.6f} / {l_p[-1]:.6f}, {ms_k:.4f} / {ms_p:.4f} "
              f"ms/round, launches {n_k} / {n_p}")
        dp = rounds if name == "porter-dp" else 0
        expect_launches(f"{name} clip kernels", n_k, ef_track=rounds,
                        ef_step=rounds, clip=rounds, mean_noise=dp)
        expect_launches(f"{name} plain clip", n_p, ef_track=rounds,
                        ef_step=rounds)
        if not same:
            s_r = run()[0]
            again = all(bit_equal(torch, s_k.x[k], s_r.x[k]) for k in s_k.x)
            raise AssertionError(f"{name}: the clip kernels' trajectory "
                                 f"differs from the plain clip's ({diff}); "
                                 f"a second kernel run is bitwise the "
                                 f"first: {again}")


def _topk_windows(torch, gen, cell, windows, w1, dt):
    if cell == "w1":
        x = torch.nn.functional.pad(w1.reshape(10, -1),
                                    (0, (-w1[0].numel()) % PACK_BLOCK))
        x = x.reshape(-1, PACK_BLOCK).contiguous()
        assert x.shape[0] == windows
    elif cell == "edge":
        x = _edge_rows(torch, gen, windows)
    else:
        x = torch.randn(windows, PACK_BLOCK, generator=gen, device=DEVICE)
    return x.to(_dtype(torch, dt)).contiguous()


def phase_block_topk_kernel(torch, ops, ref, grad, reps=20, inner=10):
    """``block_topk`` against its plain version, bitwise, at the MLP's w1
    windows, on tie / zero / -0.0 windows and at 2^24 elements, f32 and
    bf16, timed cold / warm beside its bound and ``torch.topk`` +
    ``scatter`` (nearest: not the same tie order)."""
    gen = torch.Generator(device=DEVICE).manual_seed(10)

    def nearest(x, k):
        idx = torch.topk(x.abs(), k, dim=1).indices
        return torch.zeros_like(x).scatter_(1, idx, torch.gather(x, 1, idx))

    table = {}
    for cell, (windows, ks) in TOPK_CELLS.items():
        for dt in DTYPES:
            first = _topk_windows(torch, gen, cell, windows, grad["w1"], dt)
            for k in ks:
                k_out, p_out = ops.block_topk(first, k), ref.block_topk_ref(
                    first, k)
                torch.cuda.synchronize()
                equal = bit_equal(torch, k_out, p_out)
                kept = int(((k_out != 0) | torch.signbit(k_out.float()))
                           .sum(1).max())
                err = float((k_out.float() - p_out.float()).abs().max())
                moved = 2 * first.nbytes
                if cell == "edge":
                    print(f"[block_topk] {cell} windows={windows} {dt} k={k} "
                          f"bitwise={equal} kept<={kept} max_abs_err={err}")
                    if not (equal and kept <= k):
                        raise AssertionError(f"block_topk differs from its "
                                             f"plain version at {cell} {dt} "
                                             f"k={k}: {err}, kept {kept}")
                    continue
                n_sets = -(-L2_FLUSH_BYTES // moved) + 1
                sets = [[first, k]] + [
                    [torch.randn(first.shape, generator=gen, device=DEVICE)
                     .to(first.dtype), k] for _ in range(n_sets - 1)]
                n = first.numel()
                row = dict(elements=n, equal=equal, max_abs_err=err,
                           bytes=moved, kept_max=kept,
                           ms=device_time_ms(ops.block_topk, sets, reps,
                                             inner),
                           ms_warm=device_time_ms(ops.block_topk, sets[:1],
                                                  reps, inner),
                           plain_ms=device_time_ms(ref.block_topk_ref, sets,
                                                   reps, inner),
                           nearest_ms=device_time_ms(nearest, sets, reps,
                                                     inner))
                t_bytes = moved / HBM_BYTES_PER_S
                t_ops = TOPK_OPS * n / F32_OPS_PER_S
                row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
                row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                table[(cell, dt, k)] = row
                print(f"[block_topk] {cell} windows={windows} {dt} k={k} "
                      f"bitwise={equal} kept<={kept} max_abs_err={err} "
                      f"bytes={moved} us={1e3 * row['ms']:.3f} us_warm="
                      f"{1e3 * row['ms_warm']:.3f} plain_us="
                      f"{1e3 * row['plain_ms']:.3f} bound_us="
                      f"{1e3 * row['bound_ms']:.3f} ({row['bound_by']}) "
                      f"nearest_us={1e3 * row['nearest_ms']:.3f} (nearest, "
                      "not the same tie order: torch.topk + scatter)")
                if not (equal and kept <= k):
                    raise AssertionError(f"block_topk differs from its plain "
                                         f"version at {cell} {dt} k={k}: "
                                         f"{err}, kept {kept}")
                del sets
    return table


def phase_launch_host_cost(torch, ops, calls=2000):
    """Wall µs a call over ``calls`` back-to-back calls on one small
    operand (one 8192 tile, one 2048 window), ended by one synchronize:
    the host's cost of a call wherever it exceeds the device's few µs.
    The ctypes wrappers (checks, ``torch.cuda.device``, the stream
    lookup, the library call) against PyTorch ops on the same operand."""
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    tile = torch.randn(1, TILE, generator=gen, device=DEVICE)
    win = torch.randn(1, PACK_BLOCK, generator=gen, device=DEVICE)
    one = torch.ones(1, device=DEVICE)
    fns = {"ops.clip_planes": lambda: ops.clip_planes(tile, 1, 1.0),
           "ops.clip_sumsq + smooth_factors + clip_scale":
               lambda: ops.clip_scale(tile, ops.smooth_factors(
                   ops.clip_sumsq(tile), 1, 1.0)),
           "ops.dp_mean_noise": lambda: ops.dp_mean_noise(
               tile, 1, 1, tile, DP_SIGMA),
           "ops.clip_sumsq": lambda: ops.clip_sumsq(tile),
           "ops.clip_scale": lambda: ops.clip_scale(tile, one),
           "ops.block_topk k=102": lambda: ops.block_topk(win, 102),
           "torch.mul": lambda: torch.mul(tile, one),
           "torch.linalg.vector_norm": lambda: torch.linalg.vector_norm(
               tile, dim=1)}
    cost = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        cost[name] = 1e6 * (time.perf_counter() - t0) / calls
    print("[host] wall us a call, back to back: " + ", ".join(
        f"{k} {v:.2f}" for k, v in cost.items()))
    return cost


def phase_block_top_k(torch, ops, api, data, runtime, paper, num=60000,
                      rounds=200):
    """PORTER-GC on the full-width MLP with the ``block_top_k`` compressor
    (5 %) on the dense wire, f32 and bf16 planes, kernel and ref backends:
    the MLP phase's gates, with 8 ``block_topk`` launches a round (4 leaves,
    2 exchanges) on both backends."""
    source, base, loss_fn = _mlp_problem(api, data, paper, num)
    spec = base.replace(compressor="block_top_k")
    launches, ms_rounds = {}, {}
    for plane in (None, "bf16"):
        label = plane or "f32"
        runs = {}
        for backend in ("kernel", "ref"):
            algo = _build(api, spec.replace(comm_backend=backend,
                                            plane_dtype=plane), loss_fn)
            state, losses, ms, counts = run_counted(
                torch, ops, runtime, algo, source, _init(algo, paper),
                rounds, 50)
            runs[backend] = (state, losses, counts)
            ms_rounds[f"{label} {backend}"] = ms
            print(f"[block_top_k] porter-gc {label} {backend} {rounds} "
                  f"rounds: loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
                  f"{ms:.4f} ms/round, launches {counts}")
            if not finite(losses):
                raise AssertionError(f"block_top_k {label} {backend}: loss "
                                     "is not finite")
        (s_k, l_k, n_k), (s_r, _, n_r) = runs["kernel"], runs["ref"]
        same = all(bit_equal(torch, s_k.x[k], s_r.x[k]) for k in s_k.x)
        diff = max(float((s_k.x[k] - s_r.x[k]).abs().max()) for k in s_k.x)
        print(f"[block_top_k] {label} kernel vs ref backend: x bitwise equal "
              f"{same}, max |x diff| {diff}")
        if plane is None and not diff <= 1e-6:
            raise AssertionError(f"block_top_k kernel and ref trajectories "
                                 f"differ: {diff}")
        if plane is not None and not same:
            raise AssertionError(f"block_top_k bf16 kernel and ref "
                                 f"trajectories differ: {diff}")
        common = dict(clip=rounds, block_topk=8 * rounds)
        expect_launches(f"block_top_k {label} kernel", n_k, ef_track=rounds,
                        ef_step=rounds,
                        sr_epilogue=5 * rounds if plane else 0, **common)
        expect_launches(f"block_top_k {label} ref", n_r, **common)
        _falls(f"block_top_k porter-gc {label}", l_k)
        launches[label] = n_k
    print(f"[block_top_k] ms/round: {ms_rounds}")
    algo = _build(api, spec.replace(comm_backend="kernel"), loss_fn)
    profile_rounds(torch, runtime, algo, source, _init(algo, paper), 20,
                   "block_top_k kernel")
    return launches


# phase 9: the schedules, the directed schedules and the last four
# algorithms of the registry, on the full-width MLP (PR 23).  Churn rounds
# drop agents or links, and best-constant weights have no closed form on a
# disconnected round, so the churn schedules take Metropolis weights.
SCHEDULES = {"erdos_renyi": "erdos_renyi:period=8",
             "dropout": "dropout:rate=0.2,period=8,weights=metropolis",
             "straggler": "straggler:rate=0.3,period=8,weights=metropolis"}
DIRECTED = {"ring_skips": "directed:ring_skips,skip=2",
            "digraph": "directed:digraph,p=0.5,period=8"}
SUBGRAD_GAMMA = 0.05     # sign and low_rank report rho 0: gamma is given


def _state_tensors(tree_leaves, state):
    """Every tensor of a state, nested states (``base``) included, not
    their int round counters."""
    return [leaf for leaf in tree_leaves(tuple(
        getattr(state, f) for f in state._fields if f != "step"))
        if not isinstance(leaf, int)]


def _states_equal(torch, tree_leaves, a, b) -> bool:
    la, lb = _state_tensors(tree_leaves, a), _state_tensors(tree_leaves, b)
    return len(la) == len(lb) and all(bit_equal(torch, x, y)
                                      for x, y in zip(la, lb))


def _x(state):
    return state.base.x if hasattr(state, "base") else state.x


def phase_extensions(torch, ops, api, data, runtime, paper, tree_leaves,
                     static_runs, num=60000, rounds=200, short=50):
    """The port's paths of this slice on the full-width MLP (784 -> 64 ->
    10, 10 agents, ER(0.8), top-k 5 %), through ``api.build`` and
    ``run_chunked``: PORTER-GC on three time-varying schedules, kernel vs
    ref backend in f32 (x within 1e-6) and bf16 (bitwise), and a period-1
    ``static`` schedule bitwise the static topology's run of phase 4
    (``static_runs``); porter-adam (f32, bf16), clip21 (and at tau = inf
    bitwise porter-gc with a piecewise clip at tau = inf), subgrad-comp
    with ``sign`` and ``low_rank``; dp-csgp on a directed ring with a skip
    and on a random digraph of period 8, f32 and bf16, and over the
    packed wire, with the push-sum weights' mass and sign, and bitwise
    porter-dp on the static ER(0.8) table.  Every path is counted from 0;
    the ER schedule, porter-adam and dp-csgp on the digraph (f32) are
    profiled once each.  Returns each run's ms a round."""
    source, base, loss_fn = _mlp_problem(api, data, paper, num)
    ms_rounds = {}

    def run(label, spec, steps, w=None):
        algo = _build(api, spec, loss_fn)
        state = algo.init(paper.mlp_init(seed=0, device=DEVICE), w=w)
        state, losses, ms, counts = run_counted(
            torch, ops, runtime, algo, source, state, steps,
            min(50, steps // 2))
        ms_rounds[label] = ms
        print(f"[extensions] {label} {steps} rounds: loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}, {ms:.4f} ms/round, launches {counts}")
        if not finite(losses):
            raise AssertionError(f"{label}: loss is not finite")
        return algo, state, losses, counts

    # PORTER-GC on the schedules, both backends, f32 and bf16 planes
    for name, text in SCHEDULES.items():
        for plane in (None, "bf16"):
            tag = plane or "f32"
            got = {}
            for backend in ("kernel", "ref"):
                got[backend] = run(
                    f"porter-gc {name} {tag} {backend}",
                    base.replace(topology_schedule=text,
                                 comm_backend=backend, plane_dtype=plane),
                    rounds)
            (algo, s_k, l_k, n_k), (_, s_r, _, n_r) = (got["kernel"],
                                                       got["ref"])
            period = algo.schedule.period
            same = all(bit_equal(torch, s_k.x[k], s_r.x[k]) for k in s_k.x)
            diff = max(float((s_k.x[k] - s_r.x[k]).abs().max())
                       for k in s_k.x)
            print(f"[extensions] porter-gc {name} (period {period}) {tag} "
                  f"kernel vs ref backend: x bitwise equal {same}, max |x "
                  f"diff| {diff}")
            if not (diff <= 1e-6 if plane is None else same):
                raise AssertionError(f"{name} {tag}: kernel and ref "
                                     f"trajectories differ: {diff}")
            expect_launches(f"{name} {tag} kernel", n_k, ef_track=rounds,
                            ef_step=rounds, clip=rounds,
                            sr_epilogue=5 * rounds if plane else 0)
            expect_launches(f"{name} {tag} ref", n_r, clip=rounds)
            _falls(f"porter-gc {name} {tag}", l_k)
            if name == "erdos_renyi" and plane is None:
                profile_rounds(torch, runtime, algo, source,
                               _init(algo, paper), 20,
                               "porter-gc erdos_renyi schedule")
    _, s_static, _, n_static = run(
        "porter-gc static schedule f32 kernel",
        base.replace(topology_schedule="static", comm_backend="kernel"),
        rounds)
    s_topo = static_runs[("f32", "kernel")][0]
    same = _states_equal(torch, tree_leaves, s_static, s_topo)
    print(f"[extensions] period-1 static schedule vs the static topology "
          f"(phase 4): final state bitwise equal {same}")
    if not same:
        raise AssertionError("the static schedule's state is not the static "
                             "topology's")
    expect_launches("static schedule", n_static, ef_track=rounds,
                    ef_step=rounds, clip=rounds)

    # porter-adam: the step's f32 update beside bf16 EF planes enters the
    # ef_step kernel as f32 operands, its q and m rounded by sr_cast
    for plane in (None, "bf16"):
        tag = plane or "f32"
        algo, state, losses, counts = run(
            f"porter-adam {tag}",
            base.replace(algo="porter-adam", eta=0.002, plane_dtype=plane),
            rounds)
        if plane is None:
            profile_rounds(torch, runtime, algo, source, _init(algo, paper),
                           20, "porter-adam")
        dtypes = {str(v.dtype) for tree in (state.m, state.s)
                  for v in tree.values()}
        print(f"[extensions] porter-adam {tag}: moments {sorted(dtypes)}, "
              f"q_x {state.base.q_x['w1'].dtype}")
        if dtypes != {"torch.float32"}:
            raise AssertionError(f"porter-adam moments are {dtypes}")
        expect_launches(f"porter-adam {tag}", counts, ef_track=rounds,
                        ef_step=rounds, clip=rounds,
                        sr_epilogue=3 * rounds if plane else 0,
                        sr_cast=2 * rounds if plane else 0)
        _falls(f"porter-adam {tag}", losses)

    # clip21: the residual clip is eager (piecewise), the raw gradient
    # unclipped, so no clip launch; at tau = inf bitwise porter-gc
    _, _, losses, counts = run("clip21 tau 1", base.replace(algo="clip21"),
                               rounds)
    expect_launches("clip21", counts, ef_track=rounds, ef_step=rounds)
    _falls("clip21", losses)
    _, s_c21, _, _ = run("clip21 tau inf",
                         base.replace(algo="clip21", tau=None), short)
    _, s_gc, _, _ = run("porter-gc piecewise tau inf",
                        base.replace(tau=float("inf"),
                                     clip_mode="piecewise"), short)
    same = _states_equal(torch, tree_leaves, s_c21.base, s_gc)
    print(f"[extensions] clip21 at tau = inf vs porter-gc piecewise at tau "
          f"= inf: final state bitwise equal {same}")
    if not same:
        raise AssertionError("clip21 at tau = inf is not porter-gc's")

    # subgrad-comp: CHOCO's round (ef_gossip) with eta / sqrt(t + 1)
    for comp, kw, steps in (("sign", {}, rounds),
                            ("low_rank", {"rank": 2}, short)):
        _, _, losses, counts = run(
            f"subgrad-comp {comp}",
            base.replace(algo="subgrad-comp", compressor=comp,
                         compressor_kwargs=kw, gamma=SUBGRAD_GAMMA), steps)
        expect_launches(f"subgrad-comp {comp}", counts, ef_gossip=steps,
                        clip=steps)
        if comp == "sign":
            _falls("subgrad-comp sign", losses)

    # dp-csgp on the directed schedules, f32 and bf16, and the packed wire
    dp = base.replace(algo="dp-csgp", sigma_p=DP_SIGMA)
    cases = [(name, text, plane, {}) for name, text in DIRECTED.items()
             for plane in (None, "bf16")]
    cases.append(("digraph", DIRECTED["digraph"], None,
                  dict(wire="packed_bits", gossip_mode="packed")))
    for name, text, plane, wire in cases:
        tag = (plane or "f32") + (" packed_bits" if wire else "")
        algo, state, _, counts = run(
            f"dp-csgp {name} {tag}",
            dp.replace(topology_schedule=text, plane_dtype=plane, **wire),
            short)
        xw = state.xw.double()
        mass = float(xw.sum())
        print(f"[extensions] dp-csgp {name} (period "
              f"{algo.schedule.period}) {tag}: sum xw {mass!r}, xw in "
              f"[{float(xw.min())!r}, {float(xw.max())!r}], weight planes "
              f"{sorted({str(state.xw.dtype), str(state.q_w.dtype), str(state.m_w.dtype)})}")
        if not (abs(mass - 10) <= 1e-5 and bool((xw > 0).all())):
            raise AssertionError(f"dp-csgp {name} {tag}: weights {xw}")
        if state.xw.dtype != torch.float32:
            raise AssertionError("dp-csgp weight planes are not f32")
        want = dict(ef_track=short, ef_step=short, clip=short,
                    mean_noise=short, sr_epilogue=5 * short if plane else 0)
        if wire:
            want.update(topk_pack=2 * short, topk_unpack=2 * short)
        expect_launches(f"dp-csgp {name} {tag}", counts, **want)
        if name == "digraph" and plane is None and not wire:
            profile_rounds(torch, runtime, algo, source, _init(algo, paper),
                           20, "dp-csgp digraph")
    algo, s_csgp, _, _ = run("dp-csgp static ER(0.8)", dp, short)
    _, s_pdp, _, _ = run("porter-dp static ER(0.8), init(w=W)",
                         base.replace(algo="porter-dp", sigma_p=DP_SIGMA),
                         short, w=algo.topology.w)
    same = _states_equal(
        torch, tree_leaves, s_pdp,
        type(s_pdp)(*[getattr(s_csgp, f) for f in s_pdp._fields]))
    print(f"[extensions] dp-csgp vs porter-dp on the static ER(0.8) table: "
          f"final state bitwise equal {same}, xw all 1 "
          f"{bool((s_csgp.xw == 1).all())}")
    if not (same and bool((s_csgp.xw == 1).all())):
        raise AssertionError("dp-csgp on a doubly stochastic table is not "
                             "porter-dp's")
    print(f"[extensions] ms/round: {ms_rounds}")
    return ms_rounds


# phase 10: fleet-scale agents (the n = 4096 rung of
# benchmarks/fleet_ablation.py) and checkpoint / resume
FLEET_N = 4096
FLEET_SHARD, FLEET_BATCH, FLEET_CHUNK = 16, 4, 8
FLEET_ROUNDS = {"clip21": 40, "porter-gc": 40, "porter-dp": 16}
FLEET_BELOW = 256          # the dense gate: the fleet is the dense mixer
FLEET_BELOW_ROUNDS = 20
CKPT_SCHEDULE = "rotate:ring+complete+star"      # period 3
CKPT_ROUNDS, CKPT_AT = 8, 4                      # 4 % 3 = 1: mid-period


def _fleet_problem(api, data, n):
    """Section 5.1's logreg on Dirichlet(0.3) shards of 16 samples an
    agent, batch 4 (``benchmarks/fleet_ablation.py``), and its spec."""
    x, y = data.a9a_like(n * FLEET_SHARD, 123, seed=0)
    source = data.dirichlet_source(x, y, n_agents=n, batch=FLEET_BATCH,
                                   alpha=0.3, seed=0, device=DEVICE)
    spec = api.ExperimentSpec(algo="clip21", n_agents=n,
                              topology="exponential",
                              topology_weights="metropolis",
                              compressor="top_k", frac=0.05, eta=0.05,
                              tau=1.0, fleet=True)
    return source, spec


def _logreg_params(torch):
    return {"w": torch.zeros(123, device=DEVICE),
            "b": torch.zeros((), device=DEVICE)}


def _mixer_cost(torch, mixer, tree, t):
    """(kernel launches an apply, aten ops an apply, device µs an apply,
    host µs an apply) of ``mixer`` on ``tree``.  The launches are the CUDA
    kernels that ``torch.profiler`` records between the start and the end
    of one marked apply, inside a window that holds two applies before it
    and two after it (a window of one apply in this script has recorded
    fewer kernels than the apply launched); None where it records none.
    The ops are the aten calls that are not views, counted under a
    dispatch mode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += not func.is_view
            return func(*args, **(kwargs or {}))

    args = (tree, t) if mixer.time_varying else (tree,)
    mixer(*args)
    torch.cuda.synchronize()
    with Count() as count:
        mixer(*args)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            mixer(*args)
        torch.cuda.synchronize()
        with record_function("counted_apply"):
            mixer(*args)
            torch.cuda.synchronize()
        for _ in range(2):
            mixer(*args)
        torch.cuda.synchronize()
    events = prof.events()
    mark = next(e.time_range for e in events if e.name == "counted_apply"
                and e.device_type != DeviceType.CUDA)
    launches = sum(1 for e in events if e.device_type == DeviceType.CUDA
                   and e.name != "counted_apply"
                   and mark.start <= e.time_range.start < mark.end) or None
    device_us = 1e3 * device_time_ms(lambda: mixer(*args), [()], reps=10,
                                     inner=10, cover=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        mixer(*args)
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / 20
    return launches, count.ops, device_us, host_us


# the fleet path's kernel wrappers and their plain versions, swapped in for
# a second run of each fleet case (f32 planes: no rounding words)
FLEET_PLAIN = ("ef_track", "ef_step", "clip_planes", "dp_mean_noise")


def _plain_fleet_ops(ref):
    def ef(plain):
        def call(*a, out_dtype=None, sr_bits=None):
            if sr_bits is not None:
                raise ValueError("the fleet runs f32 planes")
            return plain(*a, out_dtype=out_dtype)
        return call
    return {"ef_track": ef(ref.ef_track_ref), "ef_step": ef(ref.ef_step_ref),
            "clip_planes": ref.clip_planes_ref,
            "dp_mean_noise": ref.dp_mean_noise_ref}


# the ef variants of the fleet path: f32 planes, and bf16 planes with the
# rounding in the epilogue (``plane_dtype="bf16"``)
FLEET_EF_VARIANTS = ("ef_track", "ef_step", "ef_track_bf16_sr",
                     "ef_step_bf16_sr")


def phase_fleet_kernels(torch, ops, ref, sc):
    """Each kernel of the fleet path against its plain version, bitwise, at
    the n = 4096 fleet's planes: ``ef_track`` and ``ef_step`` on the 4,096
    x 1-tile agent plane (f32, and bf16 with the epilogue rounding), the
    fused ``clip`` on the agent plane and on PORTER-DP's 16,384 x 1-tile
    per-sample plane (f32 and bf16, tau 0.3, 1 and 4, and tau 1 with
    noise; its route, grid and tiles a CTA printed), and ``mean_noise`` at
    4,096 groups x 4 samples x 1 tile (f32 and bf16, with the noise and
    without)."""
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    n = FLEET_N * TILE
    for name in FLEET_EF_VARIANTS:
        kern, plain, make, _, _ = _variant_fns(torch, ops, ref, name)
        args = make(gen, n)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        same = all(bit_equal(torch, g, w) for g, w in zip(got, want))
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        print(f"[fleet] kernel {name} {FLEET_N} x 1 tile: bitwise the plain "
              f"version {same}, max_abs_err {err}")
        if not same:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"the fleet plane ({err})")
        del args, got, want
    for rows in (FLEET_N, FLEET_N * FLEET_BATCH):
        for dt in DTYPES:
            p = (3 * torch.randn(rows, TILE, generator=gen, device=DEVICE)
                 ).to(_dtype(torch, dt))
            z = torch.randn(p.shape, generator=gen, device=DEVICE).to(p.dtype)
            same = []
            for tau, noise in [(tau, None) for tau in CLIP_TAUS] + [(1.0, z)]:
                got = ops.clip_planes(p, rows, tau, noise, DP_SIGMA)
                want = ref.clip_planes_ref(p, rows, tau, noise, DP_SIGMA)
                torch.cuda.synchronize()
                same.append(all(bit_equal(torch, g, w)
                                for g, w in zip(got, want)))
            plan = sc.clip_plan(p, rows)
            print(f"[fleet] kernel clip {rows} x 1 tile {dt}: route "
                  f"{plan['route']} grid {plan['grid']} tiles/cta "
                  f"{plan['tiles_per_cta']}; (clip, partials, factors) "
                  f"bitwise the plain version at taus {list(CLIP_TAUS)} and "
                  f"1 + noise: {same}")
            if not all(same):
                raise AssertionError(f"clip differs from its plain version "
                                     f"at {rows} x 1 tile {dt}: {same}")
            del p, z, got, want
    for dt in DTYPES:
        p = torch.randn(FLEET_N * FLEET_BATCH, TILE, generator=gen,
                        device=DEVICE)
        p[torch.rand(p.shape, generator=gen, device=DEVICE) < 0.1] = -0.0
        p = p.to(_dtype(torch, dt))
        z = torch.randn(FLEET_N, TILE, generator=gen, device=DEVICE)
        same = []
        for extra in ((z, DP_SIGMA), ()):
            got = ops.dp_mean_noise(p, FLEET_N, FLEET_BATCH, *extra)
            want = ref.dp_mean_noise_ref(p, FLEET_N, FLEET_BATCH, *extra)
            torch.cuda.synchronize()
            same.append(bit_equal(torch, got, want))
        print(f"[fleet] kernel mean_noise {FLEET_N} x {FLEET_BATCH} x 1 tile "
              f"{dt}: bitwise the plain version with the noise and without "
              f"{same}")
        if not all(same):
            raise AssertionError(f"mean_noise differs from its plain version "
                                 f"at {FLEET_N} x {FLEET_BATCH} x 1 {dt}")
        del p, z, got, want


def phase_fleet_runs(torch, ops, ref, api, data, runtime, flatten,
                     tree_leaves):
    """clip21 and PORTER-GC (40 rounds) and PORTER-DP (16) on the n = 4096
    fleet, through ``run_chunked`` at chunk 8: ms a round, the kernels'
    launches a round and their bounds, the COO mixer's launches and time,
    the EF plane bytes, the loss, and a profiled window.  Each run is
    repeated from the same start with the path's kernel wrappers
    (``FLEET_PLAIN``) swapped for their plain versions on the same CUDA
    tensors: the final state must be bitwise the kernels' and the plain
    run must launch no kernel."""
    source, spec = _fleet_problem(api, data, FLEET_N)
    for name, rounds in FLEET_ROUNDS.items():
        t0 = time.perf_counter()
        algo = api.build(spec.replace(
            algo=name, sigma_p=DP_SIGMA if name == "porter-dp" else 0.0),
            logreg_loss, device=DEVICE)
        build_s = time.perf_counter() - t0
        state = algo.init(_logreg_params(torch))
        state, losses, ms, counts = run_counted(
            torch, ops, runtime, algo, source, state, rounds, FLEET_CHUNK)
        x = state.base.x if hasattr(state, "base") else state.x
        plane = flatten.flat_spec(x).plane_shape
        plane_bytes = plane[0] * plane[1] * 4
        useful = sum(v[0].numel() for v in x.values()) * FLEET_N * 4
        per_round = {k: v / rounds for k, v in counts.items() if v}
        mix_launches, mix_ops, dev_us, host_us = _mixer_cost(
            torch, algo.mixer, {"w": x["w"].clone(), "b": x["b"].clone()},
            rounds)
        applies = algo.info.comm_rounds
        print(f"[fleet] {name} n={FLEET_N} ({type(algo.topology).__name__} "
              f"{algo.topology.kind}, nnz {algo.topology.nnz}, alpha "
              f"{algo.topology.alpha:.6f}, gamma {algo.gamma:.6g}, build "
              f"{build_s:.2f} s) {rounds} rounds chunk {FLEET_CHUNK}: loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}, {ms:.4f} ms/round, "
              f"launches a round {per_round}")
        print(f"[fleet] {name}: COO mixer {mix_launches} kernel launches "
              f"an apply (the profiler, one marked apply; {mix_ops} aten "
              f"ops) x {applies} applies a round = "
              f"{mix_launches and mix_launches * applies} a round; "
              f"{dev_us:.1f} us device, {host_us:.1f} us host an apply "
              f"({100 * applies * host_us / (1e3 * ms):.1f} % of the "
              f"round's wall on the host); EF plane {plane[0]} x {plane[1]} "
              f"f32 = {plane_bytes} B a plane, {useful} B of parameters "
              f"({100 * (1 - useful / plane_bytes):.2f} % padding)")
        if not finite(losses):
            raise AssertionError(f"fleet {name}: loss is not finite")
        want = dict(ef_track=rounds, ef_step=rounds)
        if name != "clip21":
            want["clip"] = rounds
        if name == "porter-dp":
            want["mean_noise"] = rounds
            print(f"[fleet] porter-dp: per-sample clip plane "
                  f"{plane[0] * FLEET_BATCH} rows")
        else:
            _falls(f"fleet {name}", losses, window=8)
        expect_launches(f"fleet {name}", counts, **want)
        saved = {k: getattr(ops, k) for k in FLEET_PLAIN}
        for k, fn in _plain_fleet_ops(ref).items():
            setattr(ops, k, fn)
        try:
            plain_state, plain_losses, plain_ms, plain_counts = run_counted(
                torch, ops, runtime, algo, source,
                algo.init(_logreg_params(torch)), rounds, FLEET_CHUNK)
        finally:
            for k, fn in saved.items():
                setattr(ops, k, fn)
        same = _states_equal(torch, tree_leaves, state, plain_state)
        print(f"[fleet] {name}: the same {rounds} rounds with "
              f"{', '.join(FLEET_PLAIN)} swapped for their plain versions: "
              f"final state bitwise the kernels' {same}, loss "
              f"{plain_losses[-1]:.6f}, {plain_ms:.4f} ms/round, launches "
              f"{ {k: v for k, v in plain_counts.items() if v} or 'none'}")
        expect_launches(f"fleet {name} plain", plain_counts)
        if not same:
            raise AssertionError(f"fleet {name}: the kernels' final state "
                                 f"differs from the plain versions'")
        del plain_state
        # each kernel's bound at these planes: its operands read once and
        # its outputs written once (f32), over HBM bandwidth
        # (PORTER-DP clips the per-sample plane, FLEET_BATCH agent planes)
        per_sample = FLEET_BATCH if name == "porter-dp" else 1
        planes = {"ef_track": 7 + 3, "ef_step": 6 + 3,
                  "clip": 2 * per_sample, "mean_noise": FLEET_BATCH + 1 + 1}
        print(f"[fleet] {name}: bounds at these planes (bytes over "
              f"{HBM_BYTES_PER_S:.3g} B/s): " + ", ".join(
                  f"{k} {1e6 * v * plane_bytes / HBM_BYTES_PER_S:.1f} us"
                  for k, v in planes.items() if k in want))
        profile_rounds(torch, runtime, algo, source, state, 8,
                       f"fleet {name} n={FLEET_N}")


def phase_fleet_coo(torch, fleet):
    """The COO apply on the card: deterministic (two applies bitwise),
    against the port's CPU apply (1e-6; bitwise printed), against
    ``densify(t) @ x`` on a 4-round ER schedule (1e-5), push included."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tree = {"w": torch.randn(FLEET_N, 123, generator=gen, device=DEVICE),
            "b": torch.randn(FLEET_N, generator=gen, device=DEVICE)}
    wvec = torch.rand(FLEET_N, generator=gen, device=DEVICE) + 0.5
    cpu_tree = {k: v.cpu() for k, v in tree.items()}
    t0 = time.perf_counter()
    sched = fleet.fleet_er_schedule(FLEET_N, period=4)
    print(f"[fleet] fleet_er_schedule({FLEET_N}, period=4): nnz a round "
          f"{sched.rows.shape[1]} padded, real {sched.round_nnz}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    cases = [("exponential", fleet.fleet_topology("exponential", FLEET_N),
              (None,)), ("er schedule", sched, range(sched.period + 1))]
    for label, obj, rounds in cases:
        mix = fleet.make_fleet_mixer(obj)
        for t in rounds:
            args = () if t is None else (t,)
            a, b = mix(tree, *args), mix(tree, *args)
            pa, pw = mix.push(tree, wvec, *args)
            same = all(bit_equal(torch, a[k], b[k]) for k in a)
            cpu = mix(cpu_tree, *args)
            _, cpu_w = mix.push(cpu_tree, wvec.cpu(), *args)
            diff = max(float((a[k].cpu() - cpu[k]).abs().max()) for k in a)
            cpu_bitwise = all(bit_equal(torch, a[k].cpu(), cpu[k])
                              for k in a) and bit_equal(
                torch, pw.cpu(), cpu_w)
            w_t = torch.as_tensor(obj.densify() if t is None
                                  else obj.densify(t % obj.period),
                                  device=DEVICE)
            dense = max(float((a[k].double() - (w_t @ v.double().reshape(
                FLEET_N, -1)).reshape(v.shape)).abs().max())
                for k, v in tree.items())
            dense_w = float((pw.double() - w_t @ wvec.double()).abs().max())
            print(f"[fleet] COO apply {label} t={t}: two applies bitwise "
                  f"{same}; card vs CPU max |diff| {diff!r}, bitwise "
                  f"{cpu_bitwise}; vs densify(t) @ x in f64 max |diff| "
                  f"{dense!r}, push weight {dense_w!r}; push params bitwise "
                  f"the mix {all(bit_equal(torch, pa[k], a[k]) for k in a)}")
            if not (same and diff <= 1e-6 and dense <= 1e-5
                    and dense_w <= 1e-5):
                raise AssertionError(f"COO apply {label} t={t} failed")


def phase_fleet_below_gate(torch, ops, api, data, runtime, tree_leaves):
    """n = 256 (the gate) on the exponential graph: the fleet run's final
    state bitwise the per-device engine's, on the card."""
    source, spec = _fleet_problem(api, data, FLEET_BELOW)
    spec = spec.replace(algo="porter-gc")
    states = {}
    for fleet_on in (False, True):
        algo = api.build(spec.replace(fleet=fleet_on), logreg_loss,
                         device=DEVICE)
        state, losses, ms, counts = run_counted(
            torch, ops, runtime, algo, source, algo.init(
                _logreg_params(torch)), FLEET_BELOW_ROUNDS, 10)
        states[fleet_on] = state
        print(f"[fleet] n={FLEET_BELOW} fleet={fleet_on} porter-gc "
              f"{FLEET_BELOW_ROUNDS} rounds: mixer "
              f"{getattr(getattr(algo.mixer, 'budget', None), 'executor', 'dense')}, "
              f"loss {losses[0]:.6f} -> {losses[-1]:.6f}, {ms:.4f} ms/round,"
              f" launches {counts}")
    same = _states_equal(torch, tree_leaves, states[True], states[False])
    print(f"[fleet] n={FLEET_BELOW}: fleet vs per-device final state bitwise "
          f"{same}")
    if not same:
        raise AssertionError("the fleet below the gate is not the per-device "
                             "engine's")


def _resume_args(spec):
    """The training driver's arguments that a resume checks."""
    import argparse
    return argparse.Namespace(topology_schedule=spec.topology_schedule,
                              plane_dtype=spec.plane_dtype, tau=spec.tau,
                              steps=CKPT_ROUNDS, epsilon=0.1, delta=1e-3,
                              local_samples=4096)


def phase_checkpoint(torch, api, data, runtime, paper, tree_leaves,
                     checkpoint, train):
    """Save at round 4 of 8 (mid-period of a period-3 schedule), restore
    into a fresh build, continue: bitwise the uninterrupted run.  PORTER-GC
    on the full-width MLP in f32 and bf16 planes on
    ``rotate:ring+complete+star``, and clip21 on the n = 4096 fleet (the
    COO path).  The MLP's card checkpoint also restores bitwise into a
    CPU-built state.  Bytes written, save and restore seconds."""
    import shutil
    mlp_source, mlp_base, mlp_loss = _mlp_problem(api, data, paper, 60000)
    fleet_source, fleet_spec = _fleet_problem(api, data, FLEET_N)
    cases = [
        ("porter-gc mlp f32", mlp_base.replace(
            topology_schedule=CKPT_SCHEDULE), mlp_loss, mlp_source,
         lambda: paper.mlp_init(seed=0, device=DEVICE)),
        ("porter-gc mlp bf16", mlp_base.replace(
            topology_schedule=CKPT_SCHEDULE, plane_dtype="bf16"), mlp_loss,
         mlp_source, lambda: paper.mlp_init(seed=0, device=DEVICE)),
        (f"clip21 fleet n={FLEET_N}", fleet_spec, logreg_loss, fleet_source,
         lambda: _logreg_params(torch)),
    ]
    root = ROOT / "build" / "chip_smoke_ckpt"
    try:
        for case in cases:
            shutil.rmtree(root, ignore_errors=True)
            _resume_case(torch, api, runtime, paper, tree_leaves,
                         checkpoint, train, root, *case)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _resume_case(torch, api, runtime, paper, tree_leaves, checkpoint, train,
                 root, label, spec, loss_fn, source, params):
    """One case of :func:`phase_checkpoint`, its checkpoint under
    ``root``."""
    algo = api.build(spec, loss_fn, device=DEVICE)
    full, _ = runtime.run_chunked(algo, source, algo.init(params()), 0,
                                  CKPT_ROUNDS, chunk=CKPT_AT)
    half, _ = runtime.run_chunked(algo, source, algo.init(params()), 0,
                                  CKPT_AT, chunk=CKPT_AT)
    args = _resume_args(spec)
    extra = train.ckpt_extra(algo.info, args, spec.sigma_p, 0, 0, CKPT_AT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = Path(checkpoint.save_state(str(root), half, step=CKPT_AT,
                                      extra=extra))
    save_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in path.iterdir())
    algo2 = api.build(spec, loss_fn, device=DEVICE)
    like = algo2.init(params())
    man = checkpoint.read_manifest(str(root))
    train.check_resume(args, man["step"], man["extra"]["rounds_executed"],
                       man["extra"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = checkpoint.restore_state(str(root), like=like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    resumed, _ = runtime.run_chunked(algo2, source, restored, 0, CKPT_ROUNDS,
                                     chunk=CKPT_AT, start=CKPT_AT)
    step = restored.base.step if hasattr(restored, "base") else restored.step
    same = _states_equal(torch, tree_leaves, resumed, full)
    devices = {t.device.type for t in _state_tensors(tree_leaves, restored)}
    print(f"[checkpoint] {label}: saved at round {CKPT_AT} of "
          f"{CKPT_ROUNDS} ({spec.topology_schedule or 'static'}), "
          f"{nbytes} B in {len(list(path.iterdir()))} files, save "
          f"{save_s:.4f} s, restore {restore_s:.4f} s, restored step "
          f"{step!r} ({type(step).__name__}) on {sorted(devices)}; "
          f"resumed final state bitwise the uninterrupted run {same}")
    if not (same and type(step) is int and step == CKPT_AT
            and devices == {torch.device(DEVICE).type}):
        raise AssertionError(f"checkpoint {label}: resume failed")
    if label == "porter-gc mlp f32":
        cpu_algo = api.build(spec, loss_fn, device="cpu")
        cpu_state = checkpoint.restore_state(str(root), like=cpu_algo.init(
            paper.mlp_init(seed=0, device="cpu")))
        same_cpu = all(bit_equal(torch, a.cpu(), b) for a, b in zip(
            _state_tensors(tree_leaves, half),
            _state_tensors(tree_leaves, cpu_state)))
        print(f"[checkpoint] {label}: the card's checkpoint restored "
              f"into a CPU-built state bitwise {same_cpu}")
        if not same_cpu:
            raise AssertionError("the card's checkpoint does not restore "
                                 "bitwise on the CPU")


# phase 11: the last eight architectures.  Each served at full
# width through ``serve.load`` / ``make_batch`` / ``generate`` at the depth
# listed here (None: the config's own) with the parameter count the
# reference's ``jax.eval_shape`` of its ``init`` gives at that depth.  The
# two MoE models are cut to the depth whose draw fits the card: one expert
# stack is drawn in f32 and cast at once (``serve.load``), so the draw
# peaks near the bf16 model plus one f32 stack and its bf16 copy (grok-1 at
# 4 layers ~67 GB, arctic at 1 ~46 GB; arctic at 2 would need ~89 GB).
DECODER_SERVE = dict(batch=4, prompt=512, gen=32)
DECODER_ARCHS = {
    "tinyllama-1.1b": (None, 1_100_048_384),
    "chatglm3-6b": (None, 6_243_584_000),
    "h2o-danube-3-4b": (None, 3_961_839_360),
    "minicpm3-4b": (None, 4_073_875_968),
    "paligemma-3b": (None, 2_511_022_080),
    "seamless-m4t-medium": (None, 615_849_984),
    "grok-1-314b": (4, 20_485_232_640),
    "arctic-480b": (1, 13_840_569_344),
}
# the serve runs whose one decode step is profiled (host-bound figures)
DECODER_PROFILED = ("minicpm3-4b", "grok-1-314b")
# decode after prefill against forward in f32, the reference oracle's
# settings (window None, capacity_factor 4.0) and tolerance: the smoke
# configs (prefill 48 positions, 16 decode steps), then at full width a
# few layers (seamless: encoder and decoder) over 512 + 8
DECODER_SMOKE = dict(batch=4, prompt=48, extra=16, tol=2e-3)
DECODER_CONSIST = {"minicpm3-4b": 4, "chatglm3-6b": 4, "paligemma-3b": 4,
                   "seamless-m4t-medium": 4, "grok-1-314b": 1}
DECODER_CONSIST_LEN = dict(prompt=512, extra=8, tol=2e-3)
# the danube smoke config (window 32) with its window: prefill 40, decode 8
DANUBE_WINDOW = dict(prompt=40, extra=8, tol=2e-3)


def _decode_against_forward(torch, serve, bundle, params, batch, p, total,
                            tol):
    """Prefill the first ``p`` positions of ``batch`` (``total`` in all; a
    VLM's patches among them, an encoder-decoder's frames beside), decode
    the rest one token at a time, and hold each step's logits against
    ``forward`` over all of them.  Returns (max |diff| per step, ok,
    max |logits|)."""
    n_pre = batch["patches"].shape[1] if "patches" in batch else 0
    with torch.inference_mode():
        full = bundle.forward(params, batch)
        pre = dict(batch, tokens=batch["tokens"][:, :p - n_pre])
        _, cache = bundle.prefill(params, pre)
        cache = serve.grow_cache(cache, total - p)
        diffs, ok = [], True
        for i in range(p, total):
            tok = batch["tokens"][:, i - n_pre:i - n_pre + 1]
            logits, cache = bundle.decode_step(params, cache, tok, i)
            diffs.append(float((logits - full[:, i]).abs().max()))
            ok = ok and torch.allclose(logits, full[:, i], rtol=tol,
                                       atol=tol)
        top = float(full.abs().max())
    return diffs, ok, top


def _oracle_bundle(cfg, models):
    """The bundle of ``cfg`` with the reference oracle's settings: no
    window, capacity factor 4 (no token dropped in prefill or decode)."""
    return models.build_model(dataclasses.replace(
        cfg, window=None, capacity_factor=4.0), device=DEVICE)


def phase_decoder_smoke(torch, ops, serve, models):
    """The eight smoke configs on the card in f32, the reference oracle's
    settings: decode after prefill against ``forward``; then the danube
    smoke config with its 32 window, decoding past it."""
    c = DECODER_SMOKE
    p, total = c["prompt"], c["prompt"] + c["extra"]
    bad = []
    ops.reset_launches()
    for arch in DECODER_ARCHS:
        cfg, _, params = serve.load(arch, smoke=True, device=DEVICE, seed=8,
                                    dtype=torch.float32)
        bundle = _oracle_bundle(cfg, models)
        batch = serve.make_batch(cfg, c["batch"], total, DEVICE, seed=9)
        diffs, ok, top = _decode_against_forward(torch, serve, bundle,
                                                 params, batch, p, total,
                                                 c["tol"])
        print(f"[decoder] smoke {cfg.name} f32 (window None, capacity 4): "
              f"prefill {p} then decode {p + 1}..{total} against forward: "
              f"max |diff| {max(diffs)} (tolerance {c['tol']}), |logits| up "
              f"to {top}")
        if not ok:
            bad.append((cfg.name, diffs))
    c = DANUBE_WINDOW
    p, total = c["prompt"], c["prompt"] + c["extra"]
    cfg, bundle, params = serve.load("h2o-danube-3-4b", smoke=True,
                                     device=DEVICE, seed=8,
                                     dtype=torch.float32)
    batch = serve.make_batch(cfg, DECODER_SMOKE["batch"], total, DEVICE,
                             seed=10)
    diffs, ok, top = _decode_against_forward(torch, serve, bundle, params,
                                             batch, p, total, c["tol"])
    print(f"[decoder] smoke {cfg.name} f32 window {cfg.window}: prefill {p} "
          f"then decode {p + 1}..{total} (past the window) against the "
          f"windowed forward: max |diff| {max(diffs)} (tolerance "
          f"{c['tol']}), |logits| up to {top}")
    if not ok:
        bad.append((cfg.name + " window", diffs))
    expect_launches("decoder smoke", dict(ops.LAUNCHES))
    if bad:
        raise AssertionError(f"decoder smoke: decode differs from forward: "
                             f"{bad}")


def phase_decoder_serve(torch, ops, serve, tree_leaves):
    """The eight architectures at full width (the MoE models at reduced
    depth), random parameters drawn on the card: serve batch 4 x prompt
    512 and 32 greedy decode steps each through ``launch.serve``, one
    model at a time.  Returns {arch: figures}."""
    sc = DECODER_SERVE
    b, s, g = sc["batch"], sc["prompt"], sc["gen"]
    rates = {}
    for arch, (depth, want) in DECODER_ARCHS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, bundle, params = serve.load(arch, device=DEVICE, seed=0,
                                         n_layers=depth)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for t in tree_leaves(params))
        n_bytes = sum(t.nbytes for t in tree_leaves(params))
        layers = (f"{cfg.n_enc_layers} + {cfg.n_layers}"
                  if cfg.family == "encdec" else f"{cfg.n_layers}")
        print(f"[decoder] {cfg.name} ({cfg.family}{', MLA' if cfg.mla else ''}"
              f"): {layers} layers{' (cut)' if depth else ''}, d "
              f"{cfg.d_model}, vocab {cfg.vocab}: {n_params} parameters "
              f"(expected {want}) drawn on {DEVICE} in {load_s:.2f} s, "
              f"{n_bytes} B resident, peak {load_peak} B while drawing")
        if n_params != want:
            raise AssertionError(f"{arch} has {n_params} parameters, "
                                 f"expected {want}")
        torch.cuda.empty_cache()
        batch = serve.make_batch(cfg, b, s, DEVICE, seed=1)
        serve.generate(bundle, params, batch, 2)       # warm: library set-up
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        out = serve.generate(bundle, params, batch, g)
        launches = dict(ops.LAUNCHES)
        ids = out["ids"]
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (out["prefill_logits"], out["logits"]))
        in_range = bool(((ids >= 0) & (ids < cfg.vocab)).all())
        peak = torch.cuda.max_memory_allocated()
        fig = {"params": n_params, "resident_bytes": n_bytes,
               "load_peak_bytes": load_peak, "peak_bytes": peak,
               "prefill_tok_s": b * s / out["prefill_s"],
               "decode_tok_s": b * g / out["decode_s"],
               "decode_ms_step": 1e3 * out["decode_s"] / g}
        print(f"[decoder] {cfg.name} serve batch={b} prompt={s} gen={g}: "
              f"prefill {out['prefill_s']:.4f} s = "
              f"{fig['prefill_tok_s']:.1f} tok/s, decode "
              f"{out['decode_s']:.4f} s = {fig['decode_tok_s']:.1f} tok/s "
              f"({fig['decode_ms_step']:.3f} ms/step), ids "
              f"{tuple(ids.shape)} in range {in_range}, logits finite "
              f"{finite}, peak memory {peak} B, sample ids "
              f"{ids[0, :8].tolist()}")
        expect_launches(f"{arch} serve", launches)
        if not (finite and in_range and tuple(ids.shape) == (b, g + 1)):
            raise AssertionError(f"{arch} serve: finite {finite}, ids in "
                                 f"range {in_range}, ids {tuple(ids.shape)}")
        if arch in DECODER_PROFILED:
            with torch.inference_mode():
                # one more step at the grown cache's last slot (in place)
                prof = _profile_call(
                    torch, f"one {cfg.name} decode step",
                    lambda: bundle.decode_step(params, out["cache"],
                                               ids[:, -1:], s + g - 1),
                    "decoder", None)
                prof_pre = _profile_call(
                    torch, f"one {cfg.name} prefill",
                    lambda: bundle.prefill(params, batch), "decoder", None)
            fig["decode_profile"], fig["prefill_profile"] = prof, prof_pre
        rates[arch] = fig
        del params, bundle, out
    torch.cuda.empty_cache()
    return rates


def phase_decoder_consistency(torch, ops, serve, models):
    """At full width in f32, a few layers, the reference oracle's
    settings: decode after a 512-position prefill against ``forward``."""
    c = DECODER_CONSIST_LEN
    p, total = c["prompt"], c["prompt"] + c["extra"]
    bad = []
    ops.reset_launches()
    for arch, depth in DECODER_CONSIST.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, _, params = serve.load(arch, device=DEVICE, seed=2,
                                    dtype=torch.float32, n_layers=depth,
                                    n_enc_layers=depth)
        bundle = _oracle_bundle(cfg, models)
        batch = serve.make_batch(cfg, DECODER_SERVE["batch"], total, DEVICE,
                                 seed=3)
        diffs, ok, top = _decode_against_forward(torch, serve, bundle,
                                                 params, batch, p, total,
                                                 c["tol"])
        print(f"[decoder] consistency {cfg.name} f32 at {depth} layers "
              f"(window None, capacity 4): prefill {p} then decode "
              f"{p + 1}..{total} against forward: max |diff| first step "
              f"{diffs[0]}, all steps {max(diffs)} (tolerance {c['tol']}); "
              f"|logits| up to {top}; peak memory "
              f"{torch.cuda.max_memory_allocated()} B")
        if not ok:
            bad.append((arch, diffs))
        del params, bundle
    torch.cuda.empty_cache()
    expect_launches("decoder consistency", dict(ops.LAUNCHES))
    if bad:
        raise AssertionError(f"decoder consistency: decode differs from "
                             f"forward: {bad}")


# ---------------------------------------------------------------------------
# phase 12: LM training
# ---------------------------------------------------------------------------

# the full-width training cell: tinyllama-1.1b at its published width
# (src/repro/configs/tinyllama_1_1b.py: d 2048, 32 heads / 4 KV heads, d_ff
# 5632 SwiGLU, vocab 32000, untied head), depth cut to 2 of 22 layers: 4
# agents' seven PorterState trees and a round's planes must fit in 80 GB
LM_ARCH = "tinyllama-1.1b"
LM_LAYERS = 2
LM_PARAMS = 219_162_624          # 131.1 M embed + head, 44.0 M a layer
LM_RUN = dict(agents=4, batch=4, seq=64, frac=0.05, eta=3e-2, tau=1.0,
              chunk=10, rounds=20, profiled=5, block_rounds=2)
# the EF planes of the cell: bf16 (x f32 3.51 GB + six bf16 trees 10.5
# GB), since the f32 cell does not fit: on an H100 80GB its round runs
# out of memory in ef_step's outputs at 68.6 GiB allocated, each old
# state donated or not
LM_PLANE_DTYPE = "bf16"
LM_PEAK_LIMIT = 76e9
# the plain versions run over this many tiles (or windows) at a time
# beside the kernels' whole-plane calls: the ef kernels and block_topk are
# elementwise / windowwise, so the slices give the plain result bit for bit
LM_SLICE = 2048
LM_BACKEND_TOL = 1e-6            # kernel vs ref backend, x, f32 (the MLP's)
LM_SMOKE = dict(steps=5, chunk=5, seq=64, grad_tol=1e-4)
LM_REMAT_TOL = 1e-6
LM_TIMED = {"ef_track": "src/repro/kernels/ef_update.py:69",
            "ef_step": "src/repro/kernels/ef_update.py:96"}


def _lm_cfg(configs):
    return dataclasses.replace(configs.get_config(LM_ARCH),
                               n_layers=LM_LAYERS)


class _LmChecks:
    """For one round, ``ops.ef_track``, ``ops.ef_step``, ``ops.clip_planes``
    and ``ops.block_topk`` wrapped: each call runs the kernel on the
    round's own planes, then the plain version on the same CUDA operands
    (the ef kernels and ``block_topk`` slice by slice, ``clip`` whole), and
    records whether every output is bitwise the plain one."""

    NAMES = ("ef_track", "ef_step", "clip_planes", "block_topk")

    def __init__(self, torch, ops, ref):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.saved = {k: getattr(ops, k) for k in self.NAMES}
        self.calls = []

    def __enter__(self):
        for name in self.NAMES:
            setattr(self.ops, name, getattr(self, "_" + name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def _slices(self, n):
        return [(lo, min(lo + LM_SLICE, n)) for lo in range(0, n, LM_SLICE)]

    def _ef(self, name, n_planes, *a, out_dtype=None, sr_bits=None):
        torch, ref = self.torch, self.ref
        outs = self.saved[name](*a, out_dtype=out_dtype, sr_bits=sr_bits)
        planes, scalars = a[:n_planes], a[n_planes:]
        plain = getattr(ref, name + "_ref")
        equal = True
        for lo, hi in self._slices(planes[0].shape[0]):
            part = [p[lo:hi] for p in planes]
            if sr_bits is None:
                want = plain(*part, *scalars, out_dtype=out_dtype)
            else:
                f32 = plain(*part, *scalars, out_dtype=torch.float32)
                want = tuple(o if w is None else ref.sr_cast_ref(o, w[lo:hi])
                             for o, w in zip(f32, sr_bits))
            equal = equal and all(bit_equal(torch, o[lo:hi], w)
                                  for o, w in zip(outs, want))
        self.calls.append((name, tuple(planes[0].shape),
                           str(planes[0].dtype), equal))
        return outs

    def _ef_track(self, *a, **kw):
        return self._ef("ef_track", 7, *a, **kw)

    def _ef_step(self, *a, **kw):
        return self._ef("ef_step", 6, *a, **kw)

    def _clip_planes(self, planes, rows, tau, noise=None, sigma=0.0):
        out = self.saved["clip_planes"](planes, rows, tau, noise, sigma)
        want = self.ref.clip_planes_ref(planes, rows, tau, noise, sigma)
        equal = all(bit_equal(self.torch, o, w) for o, w in zip(out, want))
        del want
        self.calls.append(("clip", tuple(planes.shape), str(planes.dtype),
                           equal))
        return out

    def _block_topk(self, windows, k):
        out = self.saved["block_topk"](windows, k)
        equal = all(bit_equal(self.torch, out[lo:hi],
                              self.ref.block_topk_ref(windows[lo:hi], k))
                    for lo, hi in self._slices(windows.shape[0]))
        self.calls.append(("block_topk", tuple(windows.shape),
                           str(windows.dtype), equal))
        return out

    def report(self, label):
        for name, shape, dt, equal in self.calls:
            print(f"[lm-train] {label}: {name} on the round's {dt} plane "
                  f"{shape} bitwise its plain version: {equal}")
        bad = [c for c in self.calls if not c[3]]
        if not self.calls or bad:
            raise AssertionError(f"{label}: kernels differ from their plain "
                                 f"versions on the LM planes: {bad}")
        return {name: sum(1 for c in self.calls if c[0] == name)
                for name in {c[0] for c in self.calls}}


def _lm_round_launches(plane_dtype, rounds):
    """A PORTER-GC round's kernels: one clip, one ef_track, one ef_step
    (with bf16 planes five stochastic roundings in their epilogues)."""
    want = dict(ef_track=rounds, ef_step=rounds, clip=rounds)
    if plane_dtype == "bf16":
        want["sr_epilogue"] = 5 * rounds
    return want


def phase_lm_cell(torch, ops, ref, runtime, steps, data, configs,
                  tree_leaves):
    """(a) PORTER-GC on the full-width tinyllama cell: launches a round,
    ms a round, the peak memory, the device's busy share, the ef and clip
    kernels bitwise their plain versions on a round's own planes, and one
    round on the kernel backend against one on the ref backend.  Returns
    a dict of the figures."""
    c = LM_RUN
    cfg = _lm_cfg(configs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = steps.build_train_step(
        cfg, c["agents"], compressor_name="top_k", frac=c["frac"],
        eta=c["eta"], tau=c["tau"], plane_dtype=LM_PLANE_DTYPE,
        device=DEVICE)
    state = setup.init_state(torch.Generator(device=DEVICE).manual_seed(0))
    n_params = sum(leaf[0].numel() for leaf in tree_leaves(state.x))
    ef_bytes = sum(leaf.nbytes for f in state[:7] for leaf in tree_leaves(f))
    print(f"[lm-train] {cfg.name} {cfg.n_layers} of 22 layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}: {n_params} parameters an agent "
          f"(expected {LM_PARAMS}), {c['agents']} agents, planes "
          f"{LM_PLANE_DTYPE or 'f32'}, state {ef_bytes} B, built in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_params != LM_PARAMS:
        raise AssertionError(f"lm-train: {n_params} parameters, expected "
                             f"{LM_PARAMS}")
    source = data.batch_source(cfg, c["agents"], c["batch"], c["seq"],
                               device=DEVICE)
    algo = setup.algorithm
    # one warm chunk, then the counted and timed rounds; each round's old
    # state is donated (three f32 or bf16 states would not fit beside a
    # round's planes)
    warm = []
    state, _ = runtime.run_chunked(
        algo, source, state, 0, c["chunk"], chunk=c["chunk"], donate=True,
        on_chunk=lambda t0, t1, st, m: warm.extend(m["loss"].tolist()))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, losses, ms = run_timed(torch, runtime.run_chunked, algo, source,
                                  state, 0, c["rounds"], c["chunk"],
                                  donate=True)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm-train] porter-gc top_k {c['frac']} {c['rounds']} rounds in "
          f"chunks of {c['chunk']} after a warm chunk: loss {losses[0]:.6f} "
          f"-> {losses[-1]:.6f}, {ms:.3f} ms/round, launches {launches}, "
          f"peak memory {peak} B ({peak / 1e9:.2f} GB)")
    if not finite(warm + losses):
        raise AssertionError(f"lm-train: non-finite losses {losses}")
    expect_launches("lm-train", launches,
                    **_lm_round_launches(LM_PLANE_DTYPE, c["rounds"]))
    if peak > LM_PEAK_LIMIT:
        raise AssertionError(f"lm-train: peak {peak} B passes "
                             f"{LM_PEAK_LIMIT:.0f} B; set LM_PLANE_DTYPE "
                             "to 'bf16'")
    # the round's own planes: each kernel bitwise its plain version
    gen_b = torch.Generator(device=DEVICE).manual_seed(21)
    with _LmChecks(torch, ops, ref) as checks:
        state, _ = algo.step(state, source(gen_b, 0),
                             torch.Generator(device=DEVICE).manual_seed(22))
    checked = checks.report("lm-train porter-gc")
    # one round on each backend from the same state and batch, frac 1.0
    batch = source(gen_b, 1)
    xs = {}
    for backend in ("kernel", "ref"):
        other = steps.build_train_step(
            cfg, c["agents"], compressor_name="top_k", frac=1.0,
            eta=c["eta"], tau=c["tau"], plane_dtype=LM_PLANE_DTYPE,
            comm_backend=backend, device=DEVICE)
        ops.reset_launches()
        new, _ = other.step(state, batch,
                            torch.Generator(device=DEVICE).manual_seed(23))
        torch.cuda.synchronize()
        print(f"[lm-train] one round on the {backend} backend (top_k 1.0): "
              f"launches {dict(ops.LAUNCHES)}")
        xs[backend] = new.x
        del new
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(xs["kernel"]), tree_leaves(xs["ref"])))
    same = all(bit_equal(torch, a, b) for a, b in
               zip(tree_leaves(xs["kernel"]), tree_leaves(xs["ref"])))
    print(f"[lm-train] kernel vs ref backend, one round: x bitwise equal "
          f"{same}, max |x diff| {diff} (tolerance {LM_BACKEND_TOL})")
    if not diff <= LM_BACKEND_TOL:
        raise AssertionError(f"lm-train: kernel and ref rounds differ: "
                             f"{diff}")
    del xs, batch
    # the device's busy share over a few rounds (the state is donated)
    box = [state]
    del state
    prof = _profile_call(torch, f"{c['profiled']} porter-gc rounds",
                         lambda: runtime.run_chunked(
                             algo, source, box.pop(), 0, c["profiled"],
                             chunk=c["profiled"], donate=True),
                         tag="lm-train", kernel=None)
    del algo, setup
    torch.cuda.empty_cache()
    return {"ms_round": ms, "launches": launches, "peak_bytes": peak,
            "checked": checked, "profile": prof, "params": n_params}


def phase_lm_kernel_times(torch, ops, ref, sc, reps=5, inner=3):
    """``ef_track`` and ``ef_step`` (f32 and the bf16 epilogue variants;
    the cell's is ``table[name]``) and ``clip`` at the LM cell's agent
    plane (4 rows x its tiles), on fresh random planes: bitwise against
    the plain version, the kernel's time, the plain version's and the
    bound.  Operands this large miss the L2 on every call."""
    rows, tiles = LM_RUN["agents"], -(-LM_PARAMS // TILE)
    n = rows * tiles * TILE
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    table = {}
    cell = "bf16_sr" if LM_PLANE_DTYPE == "bf16" else "f32"
    for name in LM_TIMED:
        for planes, variant in (("f32", name),
                                ("bf16_sr", name + "_bf16_sr")):
            kern, plain, make, _, _ = _variant_fns(torch, ops, ref, variant)
            args = make(gen, n)
            equal = all(bit_equal(torch, a, b)
                        for a, b in zip(kern(*args), plain(*args)))
            ms = device_time_ms(kern, [args], reps, inner)
            plain_ms = device_time_ms(plain, [args], 2, 1)
            b_ms, by = bound_ms(variant, n)
            table[f"{name} {planes}"] = dict(
                variant=variant, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, equal=equal, plane=f"{rows} x {tiles} tiles")
            print(f"[lm-train] {variant} at the LM plane {rows} x {tiles} "
                  f"tiles ({n} elements): bitwise={equal} us={1e3 * ms:.1f} "
                  f"plain_us={1e3 * plain_ms:.1f} bound_us={1e3 * b_ms:.1f} "
                  f"({by}: {VARIANTS[variant]['bytes'] * n} B at 3.35 "
                  f"TB/s), {100 * b_ms / ms:.1f} % of the bound")
            if not equal:
                raise AssertionError(f"lm-train: {variant} differs from its "
                                     "plain version at the LM plane")
            del args
            torch.cuda.empty_cache()
        table[name] = table[f"{name} {cell}"]
    plane = 3 * torch.randn(rows * tiles, TILE, generator=gen, device=DEVICE)
    out, want = ops.clip_planes(plane, rows, 1.0), ref.clip_planes_ref(
        plane, rows, 1.0)
    equal = all(bit_equal(torch, a, b) for a, b in zip(out, want))
    del out, want
    ms = device_time_ms(lambda p: ops.clip_planes(p, rows, 1.0), [[plane]],
                        reps, inner)
    plain_ms = device_time_ms(lambda p: ref.clip_planes_ref(p, rows, 1.0),
                              [[plane]], 2, 1)
    moved = 2 * plane.nbytes + 4 * rows * tiles + 4 * rows
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = CLIP_FUSED_OPS * n / F32_OPS_PER_S
    b_ms = 1e3 * max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    table["clip"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, equal=equal,
                         plane=f"{rows} x {tiles} tiles f32")
    plan = sc.clip_plan(plane, rows)
    table["clip"]["plan"] = plan
    print(f"[lm-train] clip at the LM gradient plane {rows} x {tiles} tiles "
          f"f32 ({plan}): "
          f"bitwise={equal} us={1e3 * ms:.1f} plain_us={1e3 * plain_ms:.1f} "
          f"bound_us={1e3 * b_ms:.1f} ({by}: {moved} B), "
          f"{100 * b_ms / ms:.1f} % of the bound")
    if not equal:
        raise AssertionError("lm-train: clip differs from its plain version "
                             "at the LM plane")
    del plane
    torch.cuda.empty_cache()
    return table


def phase_lm_block_top_k(torch, ops, ref, runtime, steps, data, configs,
                         tree_leaves, reps=5, inner=3):
    """``build_train_step``'s own default, ``block_top_k`` 5 %, on the cell
    for ``block_rounds`` rounds: ``block_topk`` (one launch a compressed
    leaf) bitwise its plain version on every leaf of the first round, and
    timed on the largest real leaf (the embedding table's exchange)."""
    c = LM_RUN
    cfg = _lm_cfg(configs)
    setup = steps.build_train_step(cfg, c["agents"],
                                   plane_dtype=LM_PLANE_DTYPE, device=DEVICE)
    spec = setup.algorithm.spec
    state = setup.init_state(torch.Generator(device=DEVICE).manual_seed(0))
    source = data.batch_source(cfg, c["agents"], c["batch"], c["seq"],
                               device=DEVICE)
    n_leaves = len(tree_leaves(state.x))
    gen_b = torch.Generator(device=DEVICE).manual_seed(25)
    with _LmChecks(torch, ops, ref) as checks:
        state, m = setup.step(state, source(gen_b, 0),
                              torch.Generator(device=DEVICE).manual_seed(26))
    checked = checks.report("lm-train block_top_k")
    ops.reset_launches()
    losses = []
    for t in range(1, c["block_rounds"]):
        state, m = setup.step(state, source(gen_b, t),
                              torch.Generator(device=DEVICE).manual_seed(t))
        losses.append(float(m["loss"]))
    launches = dict(ops.LAUNCHES)
    rounds = c["block_rounds"] - 1
    print(f"[lm-train] build_train_step defaults ({spec.compressor} "
          f"{spec.frac}, eta {spec.eta}) {c['block_rounds']} rounds: losses "
          f"{losses}, launches a round after the checked one {launches}")
    expect_launches("lm-train block_top_k", launches,
                    block_topk=2 * n_leaves * rounds,
                    **_lm_round_launches(LM_PLANE_DTYPE, rounds))
    if not finite(losses):
        raise AssertionError(f"lm-train block_top_k: losses {losses}")
    # the embedding table's exchange: every agent's 65.5 M entries as
    # windows of 2048
    emb = state.x["embed"]["table"]
    windows = emb.reshape(-1, PACK_BLOCK).contiguous()
    k = max(int(round(spec.frac * PACK_BLOCK)), 1)
    del state
    torch.cuda.empty_cache()
    equal = bit_equal(torch, ops.block_topk(windows, k),
                      ref.block_topk_ref(windows, k))
    ms = device_time_ms(ops.block_topk, [[windows, k]], reps, inner)
    plain_ms = device_time_ms(ref.block_topk_ref, [[windows, k]], 2, 1)
    n = windows.numel()
    t_bytes = 2 * windows.nbytes / HBM_BYTES_PER_S
    t_ops = TOPK_OPS * n / F32_OPS_PER_S
    b_ms = 1e3 * max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[lm-train] block_topk on the embedding leaf ({windows.shape[0]} "
          f"windows, k={k}, {windows.dtype}): bitwise={equal} us="
          f"{1e3 * ms:.1f} plain_us={1e3 * plain_ms:.1f} bound_us="
          f"{1e3 * b_ms:.1f} ({by}), {100 * b_ms / ms:.1f} % of the bound")
    if not equal:
        raise AssertionError("lm-train: block_topk differs from its plain "
                             "version on the embedding leaf")
    del windows, emb
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                equal=equal, launches_round=2 * n_leaves, checked=checked,
                plane=f"embed {n // PACK_BLOCK} windows")


def phase_lm_smoke(torch, ops, train, configs, models, data, tree_leaves):
    """(b) every architecture's smoke config trains on the card through
    ``launch.train.main``, its scans' kernels not launched; each one's f32
    loss and gradient on the card within LM_SMOKE's tolerance of the CPU's
    from the same parameters and batch; the scan wrappers refuse operands
    under ``torch.func``.  (d) PORTER-DP on tinyllama's smoke config, and
    every other registered algorithm and the fleet for 2 rounds."""
    from torch.func import grad, grad_and_value, vmap
    from repro_torch.tree import tree_map
    s = LM_SMOKE
    for arch in configs.ARCHS:
        ops.reset_launches()
        rc = train.main(["--arch", arch, "--smoke", "--steps",
                         str(s["steps"]), "--chunk", str(s["chunk"]),
                         "--log-every", str(s["steps"])])
        launches = dict(ops.LAUNCHES)
        print(f"[lm-train] main --arch {arch} --smoke: exit {rc}, launches "
              f"{launches}")
        if rc != 0:
            raise AssertionError(f"lm-train: main --arch {arch} exited {rc}")
        expect_launches(f"lm-train main {arch}", launches,
                        **_lm_round_launches(None, s["steps"]))
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32)
        cpu = models.build_model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        batch = {k: v[0] for k, v in data.batch_source(
            cfg, 1, 2, s["seq"], device="cpu")(
                torch.Generator().manual_seed(1), 0).items()}
        g_cpu, l_cpu = grad_and_value(cpu.loss)(params, batch)
        card = models.build_model(cfg, device=DEVICE)
        ops.reset_launches()
        g_dev, l_dev = grad_and_value(card.loss)(
            tree_map(lambda t: t.to(DEVICE), params),
            tree_map(lambda t: t.to(DEVICE), batch))
        torch.cuda.synchronize()
        expect_launches(f"lm-train {arch} loss on the card",
                        dict(ops.LAUNCHES))
        a = torch.cat([t.flatten().cpu() for t in tree_leaves(g_dev)])
        b = torch.cat([t.flatten() for t in tree_leaves(g_cpu)])
        g_err = float(torch.linalg.vector_norm(a - b)
                      / torch.linalg.vector_norm(b))
        l_err = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
        leaf = max(float(torch.linalg.vector_norm(x.cpu() - y)
                         / max(float(torch.linalg.vector_norm(y)), 1e-30))
                   for x, y in zip(tree_leaves(g_dev), tree_leaves(g_cpu)))
        print(f"[lm-train] {cfg.name} f32 loss and gradient, card vs CPU: "
              f"loss {float(l_dev):.7f} vs {float(l_cpu):.7f} (rel "
              f"{l_err:.3g}), gradient normwise {g_err:.3g}, worst leaf "
              f"{leaf:.3g} (tolerance {s['grad_tol']})")
        if not (l_err <= s["grad_tol"] and g_err <= s["grad_tol"]):
            raise AssertionError(f"lm-train: {arch} card vs CPU loss "
                                 f"{l_err}, gradient {g_err}")
    # the scan kernels refuse operands under grad and vmap
    b_, s_, h_, n_ = 1, 16, 2, 16
    r = torch.randn(b_, s_, h_, n_, device=DEVICE)
    logw = torch.full_like(r, -0.5)
    u = torch.zeros(h_, n_, device=DEVICE)
    s0 = torch.zeros(b_, h_, n_, n_, device=DEVICE)
    for label, fn in (
            ("grad", lambda: grad(lambda t: ops.rwkv6_scan(
                t, r, r, logw, u, s0)[0].sum())(r)),
            ("vmap", lambda: vmap(lambda t: ops.rwkv6_scan(
                t[None], r, r, logw, u, s0)[0])(r)),
            ("ssd grad", lambda: grad(lambda t: ops.ssd_scan(
                t, torch.zeros(1, 64, 4, device=DEVICE),
                torch.zeros(1, 64, 4, device=DEVICE),
                torch.zeros(1, 64, 2, device=DEVICE),
                torch.zeros(1, 2, 8, 4, device=DEVICE))[0].sum())(
                    torch.zeros(1, 64, 2, 8, device=DEVICE)))):
        try:
            fn()
        except RuntimeError as err:
            if "plain chunked form" not in str(err):
                raise
            print(f"[lm-train] the scan wrapper refuses operands under "
                  f"{label}: {str(err)[:90]}...")
        else:
            raise AssertionError(f"lm-train: a scan kernel ran under "
                                 f"{label}")
    # (d) PORTER-DP at the smoke size: one mean_noise a round
    ops.reset_launches()
    rc = train.main(["--smoke", "--algo", "porter-dp", "--steps",
                     str(s["steps"]), "--chunk", str(s["chunk"]),
                     "--log-every", "1"])
    launches = dict(ops.LAUNCHES)
    print(f"[lm-train] main --algo porter-dp --smoke: exit {rc}, launches "
          f"{launches}")
    if rc != 0:
        raise AssertionError(f"lm-train: porter-dp main exited {rc}")
    expect_launches("lm-train porter-dp", launches,
                    mean_noise=s["steps"],
                    **_lm_round_launches(None, s["steps"]))
    # every other registered algorithm, and the fleet, through main with
    # each round's old state donated: exit 0 by main's own gate
    from repro_torch import api
    runs = [["--algo", a] for a in api.list_algorithms()
            if a not in ("porter-gc", "porter-dp")]
    for extra in runs + [["--fleet"]]:
        ops.reset_launches()
        rc = train.main(["--smoke", "--steps", "2", "--chunk", "2",
                         "--log-every", "1"] + extra)
        print(f"[lm-train] main {' '.join(extra)} --smoke: exit {rc}, "
              f"launches { {k: v for k, v in ops.LAUNCHES.items() if v} }")
        if rc != 0:
            raise AssertionError(f"lm-train: main {extra} exited {rc}")


def phase_lm_remat(torch, ops, steps, data, configs, tree_leaves):
    """(c) One full-width gradient of the cell's 4 agents with
    ``remat_policy`` "full" and "dots" against the gradient without:
    within LM_REMAT_TOL normwise (bitwise printed), each with its peak
    memory.  The gradient without remat waits on the host, so that every
    call's peak stands on the same resident parameters and batch; each
    peak is printed with its rise over them."""
    from torch.func import grad_and_value, vmap
    from repro_torch.core import remat
    from repro_torch.tree import tree_map
    c = LM_RUN
    cfg = _lm_cfg(configs)
    setup = steps.build_train_step(cfg, c["agents"], device=DEVICE)
    p = setup.bundle.init(torch.Generator(device=DEVICE).manual_seed(0))
    x = tree_map(lambda t: t.unsqueeze(0).expand(
        (c["agents"],) + tuple(t.shape)).clone(), p)
    del p
    batch = data.batch_source(cfg, c["agents"], c["batch"], c["seq"],
                              device=DEVICE)(
        torch.Generator(device=DEVICE).manual_seed(27), 0)
    peaks, rises = {}, {}
    base = base_losses = None
    for policy in (None, "full", "dots"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        remat.DOTS_REPLAYS.clear()
        fn = remat.apply_remat(setup.bundle.loss, policy)
        g, losses = vmap(grad_and_value(fn))(x, batch)
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated()
        rises[policy] = peaks[policy] - resident
        if policy is None:
            base = [t.cpu() for t in tree_leaves(g)]
            base_losses = losses
            print(f"[lm-train] remat none: peak {peaks[None]} B, "
                  f"{rises[None]} B over the resident {resident} B")
            del g
            continue
        num = den = 0.0
        same = bit_equal(torch, losses, base_losses)
        for u, v_host in zip(tree_leaves(g), base):
            v = v_host.to(DEVICE)
            num += float(torch.sum((u - v).double() ** 2))
            den += float(torch.sum(v.double() ** 2))
            same = same and bit_equal(torch, u, v)
            del v
        num, den = math.sqrt(num), math.sqrt(den)
        print(f"[lm-train] remat {policy}: gradient normwise {num / den:.3g} "
              f"from no remat, bitwise {same}, peak {peaks[policy]} B, "
              f"{rises[policy]} B over the resident {resident} B (none "
              f"{rises[None]} B), dense products replayed "
              f"{dict(remat.DOTS_REPLAYS)}")
        if not num <= LM_REMAT_TOL * den:
            raise AssertionError(f"lm-train: remat {policy} gradient differs: "
                                 f"{num / den}")
        if policy == "dots" and (not remat.DOTS_REPLAYS["replayed"]
                                 or remat.DOTS_REPLAYS["computed"]):
            raise AssertionError(f"lm-train: remat dots replayed "
                                 f"{dict(remat.DOTS_REPLAYS)}")
        del g
    del base, x, batch
    torch.cuda.empty_cache()
    return {"peak": peaks, "rise": rises}


def lm_record(name, lm, lm_times):
    """A kernel's LM-plane figures (phase 12) for its record: the cell's
    variant, its µs, plain µs and bound at the LM plane (both plane dtypes
    for the ef kernels), and its launches a round."""
    row = lm_times[name]
    launches_round = (row["launches_round"] if name == "block_topk"
                      else lm["launches"][name] // LM_RUN["rounds"])
    extra = {}
    if name in LM_TIMED:
        extra["lm_variant"] = row["variant"]
        for planes in ("f32", "bf16_sr"):
            other = lm_times[f"{name} {planes}"]
            extra[f"ms_lm_{planes}"] = other["ms"]
            extra[f"bound_ms_lm_{planes}"] = other["bound_ms"]
    return {**extra, "lm_plane": row["plane"], "ms_lm": row["ms"],
            "plain_ms_lm": row["plain_ms"], "bound_ms_lm": row["bound_ms"],
            "bound_by_lm": row["bound_by"],
            "launches_lm_round": launches_round}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api, configs, data
    from repro_torch.core import average_params, clipping, fleet
    from repro_torch.kernels import build, flatten, ops, ref, smooth_clip
    from repro_torch import models
    from repro_torch.launch import checkpoint, runtime, serve, steps, train
    from repro_torch.models import paper
    from repro_torch.tree import tree_leaves

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

    # phase 4: Section-5.2 MLP at full width (the main paths' launches)
    runs, ms_per_round, dp_launches = phase_mlp(
        torch, ops, api, data, runtime, paper, tree_leaves)
    print("[mlp] median ms/round: " + ", ".join(
        f"{b} {statistics.median(v):.4f}" for b, v in ms_per_round.items()))
    choco = phase_baselines(torch, ops, api, data, runtime, paper)

    # phase 5: the bit-packed wire, its kernels and its path
    wire_table = phase_wire_kernels(torch, ops, ref)
    wire_launches = phase_wire(torch, ops, api, data, runtime, paper)

    # phase 6: the rwkv6 serving path, its kernel and its consistency
    rwkv_table = phase_rwkv6_kernel(torch, ops, ref)
    rwkv_launches, rwkv_rates = phase_rwkv6_serve(torch, ops, serve,
                                                  tree_leaves)
    torch.cuda.empty_cache()
    phase_rwkv6_consistency(torch, ops, serve)
    torch.cuda.empty_cache()

    # phase 7: the zamba2 serving path, its kernel and its consistency
    print(f"[zamba2] device memory before the phase: "
          f"{torch.cuda.memory_allocated()} B allocated, "
          f"{torch.cuda.memory_reserved()} B reserved")
    ssd_table = phase_ssd_kernel(torch, ops, ref)
    phase_zamba2_smoke(torch, ops, serve)
    ssd_launches, zamba_rates = phase_zamba2_serve(torch, ops, serve,
                                                   tree_leaves)
    torch.cuda.empty_cache()
    phase_zamba2_consistency(torch, ops, serve)
    torch.cuda.empty_cache()

    # phase 8: the clip kernels, block_topk, and the block_top_k path
    clip_table = phase_clip_kernels(torch, ops, ref)
    fused_table = phase_clip_fused(torch, ops, ref, smooth_clip)
    mean_table = phase_mean_noise(torch, ops, ref, api, data, paper, flatten,
                                  clipping)
    grad = phase_clip_gradient(torch, ops, ref, api, data, paper, flatten,
                               clipping)
    phase_clip_trajectory(torch, ops, ref, api, data, runtime, paper)
    topk_table = phase_block_topk_kernel(torch, ops, ref, grad)
    phase_launch_host_cost(torch, ops)
    topk_launches = phase_block_top_k(torch, ops, api, data, runtime, paper)

    # phase 9: schedules, directed schedules, the last four algorithms
    t9 = time.perf_counter()
    phase_extensions(torch, ops, api, data, runtime, paper, tree_leaves, runs)
    print(f"[extensions] phase took {time.perf_counter() - t9:.1f} s")

    # phase 10: fleet-scale agents, and checkpoint / resume
    t10 = time.perf_counter()
    phase_fleet_kernels(torch, ops, ref, smooth_clip)
    phase_fleet_runs(torch, ops, ref, api, data, runtime, flatten,
                     tree_leaves)
    phase_fleet_coo(torch, fleet)
    phase_fleet_below_gate(torch, ops, api, data, runtime, tree_leaves)
    phase_checkpoint(torch, api, data, runtime, paper, tree_leaves,
                     checkpoint, train)
    print(f"[fleet] phase took {time.perf_counter() - t10:.1f} s")

    # phase 11: the last eight architectures served, and their consistency
    t11 = time.perf_counter()
    phase_decoder_smoke(torch, ops, serve, models)
    decoder_rates = phase_decoder_serve(torch, ops, serve, tree_leaves)
    phase_decoder_consistency(torch, ops, serve, models)
    print(f"[decoder] phase took {time.perf_counter() - t11:.1f} s")
    print("[decoder] figures " + json.dumps(decoder_rates))

    # phase 12: LM training: the full-width cell, its kernels at the LM's
    # planes, every family's smoke config, remat and PORTER-DP
    t12 = time.perf_counter()
    lm = phase_lm_cell(torch, ops, ref, runtime, steps, data, configs,
                       tree_leaves)
    lm_times = phase_lm_kernel_times(torch, ops, ref, smooth_clip)
    lm_times["block_topk"] = phase_lm_block_top_k(
        torch, ops, ref, runtime, steps, data, configs, tree_leaves)
    phase_lm_smoke(torch, ops, train, configs, models, data, tree_leaves)
    lm["remat_peaks"] = phase_lm_remat(torch, ops, steps, data, configs,
                                       tree_leaves)
    print(f"[lm-train] phase took {time.perf_counter() - t12:.1f} s")
    print("[lm-train] figures " + json.dumps(
        {k: v for k, v in lm.items() if k != "profile"}
        | {"profile": lm["profile"], "kernels": lm_times}, default=str))


    # each kernel's launches on the path that carries its timed variant:
    # f32 PORTER-GC (ef_track, ef_step), f32 CHOCO (ef_gossip) and bf16
    # PORTER-GC (sr_cast: 0, its rounding is the ef kernels' epilogue
    # there), all on the MLP
    launches = dict(runs[("f32", "kernel")][3])
    launches["ef_gossip"] = choco["f32"]["ef_gossip"]
    bf16_mlp = runs[("bf16", "kernel")][3]
    launches["sr_cast"] = bf16_mlp["sr_cast"]

    def variant(name):
        row = table[(name, MAIN_PLANE)]
        return {"ms": row["ms"], "bound_ms": row["bound_ms"],
                "unfused_ms": row["unfused_ms"]}
    record = []
    for name, k in KERNELS.items():
        row = table[(k["variant"], MAIN_PLANE)]
        record.append(dict(
            name=name, ok=row["equal"], route="cuda", source=k["source"],
            replaces=k["replaces"], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            **(lm_record(name, lm, lm_times) if name in LM_TIMED else {}),
            **({"bf16_sr_variant": variant(name + "_bf16_sr")}
               if name != "sr_cast" else
               {"epilogue": {v: variant(v) for v in VARIANTS
                             if VARIANTS[v].get("sr")},
                "epilogue_roundings": bf16_mlp["sr_epilogue"]})))
    for name, k in WIRE_KERNELS.items():
        row = wire_table[(k["variant"], MAIN_PLANE)]
        path = "qsgd f32" if name.startswith("qsgd") else "top_k f32"
        record.append(dict(
            name=name, ok=row["equal"], route="cuda",
            source="src/repro_torch/csrc/wire_pack.cu",
            replaces=k["replaces"], launches=wire_launches[path][name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"],
            library_ms=(row["library_ms"] if name == "topk_unpack"
                        else None),
            nearest_ms=(row["library_ms"] if name == "topk_pack" else None),
            ms_logreg=wire_table[(k["variant"], "logreg")]["ms"],
            ms_2p24=wire_table[(k["variant"], "2^24")]["ms"],
            bound_ms_2p24=wire_table[(k["variant"], "2^24")]["bound_ms"]))
    row = rwkv_table["path"]
    record.append(dict(
        name="rwkv6_chunk", ok=row["ok"], route="cuda",
        source="src/repro_torch/csrc/rwkv6_chunk.cu",
        replaces="src/repro/kernels/rwkv6_chunk.py:90",
        launches=rwkv_launches, max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None, rel_err=row["rel_err"],
        bound_ms_f32_rate=row["bound_ms_f32_rate"],
        ms_2x4096=rwkv_table["2x4096"]["ms"],
        bound_ms_2x4096=rwkv_table["2x4096"]["bound_ms"], **rwkv_rates))
    row = ssd_table["path"]
    record.append(dict(
        name="ssd_chunk", ok=row["ok"], route="cuda",
        source="src/repro_torch/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_chunk.py:78",
        launches=ssd_launches, max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None, rel_err=row["rel_err"],
        bound_ms_f32_rate=row["bound_ms_f32_rate"],
        ms_f32_bc=ssd_table["path f32"]["ms"],
        ms_2x4096=ssd_table["2x4096"]["ms"],
        bound_ms_2x4096=ssd_table["2x4096"]["bound_ms"],
        ms_smoke=ssd_table["smoke"]["ms"],
        bound_ms_smoke=ssd_table["smoke"]["bound_ms"], **zamba_rates))
    # the clip kernels on PORTER-GC's agent plane (sumsq, scale: the f32
    # MLP run) and on the perturbation plane of PORTER-DP's parent route
    # (scale_noise: 0 launches on PORTER-DP, which runs mean_noise);
    # block_topk at w1's windows, k = 102, on the f32 block_top_k run
    for name, replaces in CLIP_KERNELS.items():
        plane = "dp noise" if name == "scale_noise" else "mlp"
        row = clip_table[(name, plane, "f32")]
        record.append(dict(
            name=name, ok=row["equal"], route="cuda",
            source="src/repro_torch/csrc/smooth_clip.cu", replaces=replaces,
            launches=(dp_launches if name == "scale_noise"
                      else launches)[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            nearest_ms=row["nearest_ms"], plane=plane,
            ms_bf16=clip_table[(name, plane, "bf16")]["ms"],
            ms_dp_plane=clip_table[(name, "dp", "f32")]["ms"],
            bound_ms_dp_plane=clip_table[(name, "dp", "f32")]["bound_ms"],
            ms_2p24=clip_table[(name, "2^24 x1", "f32")]["ms"],
            bound_ms_2p24=clip_table[(name, "2^24 x1", "f32")]["bound_ms"]))
    # the fused clip on PORTER-GC's agent plane (the f32 MLP run)
    row = fused_table[(MAIN_PLANE, "f32")]
    record.append(dict(
        name="clip", ok=row["equal"], route="cuda",
        source="src/repro_torch/csrc/smooth_clip.cu", replaces=CLIP_REPLACES,
        launches=launches["clip"], max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None, plane=MAIN_PLANE,
        ms_warm=row["ms_warm"], replaced_route_ms=row["route_ms"],
        sumsq_scale_ms=row["pair_ms"], plan=row["plan"],
        ms_bf16=fused_table[(MAIN_PLANE, "bf16")]["ms"],
        bound_ms_bf16=fused_table[(MAIN_PLANE, "bf16")]["bound_ms"],
        ms_dp_plane=fused_table[("dp", "f32")]["ms"],
        bound_ms_dp_plane=fused_table[("dp", "f32")]["bound_ms"],
        ms_2p24=fused_table[("2^24 x1", "f32")]["ms"],
        bound_ms_2p24=fused_table[("2^24 x1", "f32")]["bound_ms"],
        graph_replay_ms=fused_table["graph"]["ms"],
        **lm_record("clip", lm, lm_times)))
    # mean_noise on PORTER-DP's real clipped per-sample plane (the f32
    # PORTER-DP run of the MLP phase)
    row = mean_table[(MEAN_PATH, "f32")]
    dp_sgd = mean_table[(f"1 x 8 x {MEAN_TILES}", "f32")]
    record.append(dict(
        name="mean_noise", ok=row["equal"], route="cuda",
        source="src/repro_torch/csrc/smooth_clip.cu", replaces=MEAN_REPLACES,
        launches=dp_launches["mean_noise"], max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        nearest_ms=row["nearest_ms"],
        plane=f"{row['groups']} x {row['b']} x {row['tiles']}",
        ms_warm=row["ms_warm"], replaced_route_ms=row["replaced_route_ms"],
        route_ms=row["route_ms"], parent_route_ms=row["parent_route_ms"],
        ms_bf16=mean_table[(MEAN_PATH, "bf16")]["ms"],
        ms_one_group=dp_sgd["ms"], bound_ms_one_group=dp_sgd["bound_ms"]))
    row = topk_table[("w1", "f32", 102)]
    record.append(dict(
        name="block_topk", ok=row["equal"], route="cuda",
        source="src/repro_torch/csrc/block_topk.cu", replaces=TOPK_REPLACES,
        launches=topk_launches["f32"]["block_topk"],
        max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None,
        nearest_ms=row["nearest_ms"],
        ms_bf16=topk_table[("w1", "bf16", 102)]["ms"],
        ms_2p24=topk_table[("2^24", "f32", 102)]["ms"],
        bound_ms_2p24=topk_table[("2^24", "f32", 102)]["bound_ms"],
        **lm_record("block_topk", lm, lm_times)))
    print(f"[time] the whole script took "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)   # again here: a long log keeps only its end
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

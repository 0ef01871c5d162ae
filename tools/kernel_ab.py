"""Device µs of the redesigned kernels (the scans, the top-k selections,
the bf16 EF updates with their stochastic rounding, ``qsgd_pack``), and
optionally the two served models' prefills, for the port in a given source
tree, on one card: the kernels at the shapes ``chip_smoke.py`` phases 2
and 5-8 time, each from CUDA events over inputs that exceed L2:

- ``ssd_chunk`` at 4 x 512 tokens, 112 heads x 64, state 64, bf16 and f32
  B / C, and at 2 x 4096 tokens;
- ``rwkv6_chunk`` at 4 x 512 tokens, 64 heads x 64, bf16 and f32 r, k, v,
  and at 2 x 4096 tokens;
- ``block_topk`` on 250 and 8,192 windows of 2048, k = 102, f32 and bf16;
- ``topk_pack`` on 280 (the MLP's codec rows) and 8,192 windows, k = 102;
- the bf16 EF updates with their stochastic rounding (``sr``), on the
  MLP's plane (573,440 elements) and on 2^24: each of ``ef_track`` (every
  operand bf16, 3 outputs rounded), ``ef_step`` and ``ef_gossip`` (an f32
  x / y, 2 rounded) as the tree's engine runs it (the rounding in the ef
  kernel's epilogue where its ``ops.ef_*`` take ``sr_bits``, else f32
  outputs and one ``sr_cast`` an output), and as those two steps in every
  tree;
- ``qsgd_pack`` on 280 and 8,192 windows at 7 and 16 levels, and on 280
  windows at 1, 3, 127 and 32767 levels (field widths 2, 3, 8 and 16
  bits);
- ``qsgd_unpack`` on 280 and 8,192 windows at one level of each of the
  eight fields-a-word counts (1, 3, 7, 15, 16, 127, 255 and 32767 levels:
  epw 16, 10, 8, 6, 5, 4, 3, 2), and ``topk_unpack`` on 280 and 8,192
  windows at k = 102 and 512, each on the plain pack's buffers of
  Gaussian windows (``unpack``);
- the smooth clip of a row-stacked plane as the tree runs it
  (``ops.clip_planes``, tau 1: one fused launch, or ``sumsq``, the eager
  combine and ``scale``; several wrapper calls, so timed with ``cover``)
  on the MLP's agent plane (10 rows x 7 tiles) in f32 and bf16, the
  quickstart's (10 x 1), PORTER-DP's per-sample plane (80 x 7) and 2^24
  elements (1 row) (``clip``);
- the DP gradient route after the per-sample gradients, as the tree runs
  it: the MLP's per-sample gradients (Gaussian, 10 agents x 8 samples as
  PORTER-DP takes them, and one model x 8 samples as DP-SGD does) clipped,
  averaged and perturbed (one chunk of ``clipping._add_chunk`` over
  ``clipping._clipped_plane``, or ``clipping.clip_mean_noise`` in a tree
  that has it: the fused clip and ``mean_noise``; or, where the tree has
  neither, the fused clip,
  its unpack, a sum and a division a leaf and ``clipping.perturb``); several
  wrapper calls, so timed with ``cover`` (``dp``);

and with ``--prefill`` the zamba2-7b and rwkv6-7b prefills as
``launch.serve.generate`` times them (batch 4 x prompt 512, synchronized
wall clock, median of 3 after a warm call; each model freed before the
next is drawn).  ``--ptxas`` first compiles the tree's scan, top-k, wire
and EF sources with ``-Xptxas -v`` and prints each kernel's registers and
spills.
Each kernel cell also prints a SHA-256 digest of the outputs of its first
input set; the inputs come from one seed in a fixed order, so two trees
whose kernels compute bitwise alike print the same digests.

    python3 tools/kernel_ab.py [--src SRC] [--label LABEL] [--prefill] [--ptxas]
                               [--only GROUP,...]

SRC is the ``src`` directory of a checkout (default: this checkout's), so
two commits can be compared on one card in one call: unpack the other
commit into a git-ignored directory (``git archive``) and run the script
once per tree, in turns (A, B, B, A).  Each run imports ``repro_torch``
from SRC, builds that tree's kernels into its own ``build/``, and prints
one ``[kernel-ab]`` line per measurement and a JSON line of them all.
``--only`` keeps some groups of cells: ssd, rwkv6, block_topk, topk_pack,
sr, qsgd, unpack, clip, dp.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SSD_CELLS = {"ssd path bf16": ((4, 512, 112, 64, 64), "bf16"),
             "ssd path f32": ((4, 512, 112, 64, 64), "f32"),
             "ssd 2x4096 bf16": ((2, 4096, 112, 64, 64), "bf16")}
RWKV_CELLS = {"rwkv6 path bf16": ((4, 512, 64, 64), "bf16"),
              "rwkv6 path f32": ((4, 512, 64, 64), "f32"),
              "rwkv6 2x4096 bf16": ((2, 4096, 64, 64), "bf16")}
TOPK_CELLS = {"block_topk 250 f32": (250, "f32"),
              "block_topk 250 bf16": (250, "bf16"),
              "block_topk 8192 f32": (8192, "f32")}
PACK_CELLS = {"topk_pack 280": 280, "topk_pack 8192": 8192}
TOPK_K = 102
# the bf16 EF updates: (kernel, operands, scalars, rounded outputs,
# slot 2 bf16), on the MLP's plane and on 2^24 elements
SR_KERNELS = {"ef_track": (7, (0.0142897,), 3, True),
              "ef_step": (6, (0.0142897, 0.05), 2, False),
              "ef_gossip": (5, (0.0142897, 1.0), 2, False)}
SR_PLANES = {"mlp": 70, "2^24": 2048}     # tiles of 8192
QSGD_CELLS = {"qsgd_pack 280 L7": (280, 7), "qsgd_pack 8192 L7": (8192, 7),
              "qsgd_pack 280 L16": (280, 16),
              "qsgd_pack 8192 L16": (8192, 16),
              "qsgd_pack 280 L1": (280, 1), "qsgd_pack 280 L3": (280, 3),
              "qsgd_pack 280 L127": (280, 127),
              "qsgd_pack 280 L32767": (280, 32767)}
UNPACK_WINDOWS = (280, 8192)
UNPACK_LEVELS = (1, 3, 7, 15, 16, 127, 255, 32767)
UNPACK_K = (102, 512)
CLIP_CELLS = {"clip mlp f32": (10, 7, "f32"), "clip mlp bf16": (10, 7, "bf16"),
              "clip quickstart f32": (10, 1, "f32"),
              "clip dp f32": (80, 7, "f32"),
              "clip 2^24 f32": (1, 2048, "f32")}
# the DP route: (groups, samples a group); one group is a single model
DP_CELLS = {"dp porter-dp f32": (10, 8), "dp dp-sgd f32": (1, 8)}
DP_SIGMA = 0.01
GROUPS = ("ssd", "rwkv6", "block_topk", "topk_pack", "sr", "qsgd", "unpack",
          "clip", "dp")
PTXAS_SOURCES = ("rwkv6_chunk", "ssd_chunk", "wire_pack", "block_topk",
                 "ef_update")


def _sets(cs, make, first_bytes):
    """Enough input sets to exceed L2 between two calls on the same one."""
    n_sets = -(-cs.L2_FLUSH_BYTES // first_bytes) + 1
    return [make() for _ in range(n_sets)]


def _digest(torch, out) -> str:
    """SHA-256 of the bytes of a kernel's outputs (a tensor or a tuple)."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ptxas(build, label):
    """Each kernel's registers and spills, as ptxas reports them."""
    out = Path(build.BUILD_DIR) / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / f"lib{name}.so"), str(build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in PTXAS_SOURCES}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("spill" in line or "Used" in line):
                print(f"[kernel-ab] {label} ptxas {name} {entry}: "
                      f"{line.strip()}")


def _sr_fns(torch, ops, kernel):
    """(the tree's engine call, the two-step call, operand maker) of one
    bf16 EF update with its stochastic rounding: operands, then the int32
    words of the rounded outputs."""
    n_in, scalars, n_sr, y_bf16 = SR_KERNELS[kernel]
    fn = getattr(ops, kernel)
    fused = "sr_bits" in inspect.signature(fn).parameters

    def words(a):
        return tuple(a[n_in:]) + (None,) * (3 - n_sr)

    def two_step(*a):
        outs = fn(*a[:n_in], *scalars, out_dtype=torch.float32)
        return tuple(o if w is None else ops.sr_cast(o, w)
                     for o, w in zip(outs, words(a)))

    def engine(*a):
        return fn(*a[:n_in], *scalars, sr_bits=words(a))

    def make(gen, tiles):
        shape = (tiles, 8192)
        return ([torch.randn(shape, generator=gen, device="cuda").to(
            torch.float32 if i == 2 and not y_bf16 else torch.bfloat16)
            for i in range(n_in)]
            + [torch.randint(-(2**31), 2**31 - 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
               for _ in range(n_sr)])
    return (engine if fused else two_step), two_step, make, fused


def _unpack_cells(torch, ops, ref, cs, gen):
    """(name, wrapper, operand maker) of each unpack cell; the operands are
    the plain pack's buffers of fresh Gaussian windows."""
    def rows(windows):
        return torch.randn(windows, cs.PACK_BLOCK, generator=gen,
                           device="cuda")
    for windows in UNPACK_WINDOWS:
        for levels in UNPACK_LEVELS:
            def make(windows=windows, levels=levels):
                x = rows(windows)
                return list(ref.qsgd_pack_ref(
                    x, torch.rand(x.shape, generator=gen, device="cuda"),
                    levels))
            yield (f"qsgd_unpack {windows} L{levels}",
                   lambda w, s, lv=levels: ops.wire_qsgd_unpack(w, s, lv),
                   make)
        for k in UNPACK_K:
            def make(windows=windows, k=k):
                return list(ref.topk_pack_ref(rows(windows), k))
            yield f"topk_unpack {windows} k{k}", ops.wire_topk_unpack, make


def _dp_route(clipping):
    """The tree's DP gradient route from the per-sample rows (group g's
    sample s is row ``g * b + s``) and the noise tree to the perturbed
    mean, tau 1."""
    if hasattr(clipping, "_add_chunk"):
        def chunk(rows, b, stacked, noise):
            out, mean = clipping._add_chunk(
                *clipping._clipped_plane(rows, 1.0, "smooth"), b, stacked,
                DP_SIGMA, lambda *_: noise)
            return clipping.FL.from_planes(out, mean)
        return chunk
    if hasattr(clipping, "clip_mean_noise"):
        def fused(rows, b, stacked, noise):
            return clipping.clip_mean_noise(rows, b, 1.0, DP_SIGMA, noise,
                                            stacked=stacked)
        return fused

    def eager(rows, b, stacked, noise):
        lead = (-1, b) if stacked else (b,)
        mean = {k: a.reshape(lead + tuple(a.shape[1:])).sum(len(lead) - 1)
                / b for k, a in clipping.stacked_clip(rows, 1.0).items()}
        return clipping.perturb(mean, noise, DP_SIGMA)
    return eager


def _prefill(torch, serve, arch, sc, label):
    cfg, bundle, params = serve.load(arch, device="cuda", seed=0)
    tokens = serve.make_prompt(cfg, sc["batch"], sc["prompt"], "cuda", 1)
    serve.generate(bundle, params, tokens, 1)     # warm
    times = [1e3 * serve.generate(bundle, params, tokens, 1)["prefill_s"]
             for _ in range(3)]
    ms = statistics.median(times)
    print(f"[kernel-ab] {label} {arch} prefill batch {sc['batch']} x "
          f"{sc['prompt']}: ms {times}, median {ms:.3f} = "
          f"{sc['batch'] * sc['prompt'] / ms * 1e3:.1f} tok/s")
    del cfg, bundle, params, tokens
    torch.cuda.empty_cache()
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--only", default=",".join(GROUPS))
    args = ap.parse_args(argv)
    groups = set(args.only.split(","))
    if not groups <= set(GROUPS):
        ap.error(f"--only takes groups of {GROUPS}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import build, ops, ref
    print(f"[kernel-ab] {args.label}: repro_torch from "
          f"{Path(repro_torch.__file__).parent}, "
          f"{torch.cuda.get_device_name(0)}")
    if args.ptxas:
        _ptxas(build, args.label)
    gen = torch.Generator(device="cuda").manual_seed(12)
    us, digest = {}, {}
    with torch.inference_mode():
        for name, (shape, bc) in (SSD_CELLS.items() if "ssd" in groups
                                  else ()):
            first = cs._ssd_inputs(torch, gen, shape, bc)
            moved = (sum(t.nbytes for t in first)       # + y and h_final
                     + first[0].nbytes + first[4].nbytes)
            sets = _sets(cs, lambda: cs._ssd_inputs(torch, gen, shape, bc),
                         moved)
            us[name] = 1e3 * cs.device_time_ms(ops.ssd_scan, sets, 10, 5)
            digest[name] = _digest(torch, ops.ssd_scan(*sets[0]))
            print(f"[kernel-ab] {args.label} {name} {shape}: {us[name]:.3f} "
                  f"us, outputs {digest[name]}")
            del sets, first
        for name, (shape, rkv) in (RWKV_CELLS.items() if "rwkv6" in groups
                                   else ()):
            first = cs._rwkv6_inputs(torch, gen, shape, rkv)
            moved = (sum(t.nbytes for t in first)       # + o and s_final
                     + 4 * first[0].numel() + first[5].nbytes)
            sets = _sets(cs, lambda: cs._rwkv6_inputs(torch, gen, shape,
                                                      rkv), moved)
            us[name] = 1e3 * cs.device_time_ms(ops.rwkv6_scan, sets, 10, 5)
            digest[name] = _digest(torch, ops.rwkv6_scan(*sets[0]))
            print(f"[kernel-ab] {args.label} {name} {shape}: {us[name]:.3f} "
                  f"us, outputs {digest[name]}")
            del sets, first
        for name, (windows, dt) in (TOPK_CELLS.items()
                                    if "block_topk" in groups else ()):
            dtype = torch.float32 if dt == "f32" else torch.bfloat16

            def make():
                return [torch.randn(windows, cs.PACK_BLOCK, generator=gen,
                                    device="cuda").to(dtype), TOPK_K]
            nbytes = 2 * windows * cs.PACK_BLOCK * (4 if dt == "f32" else 2)
            sets = _sets(cs, make, nbytes)
            us[name] = 1e3 * cs.device_time_ms(ops.block_topk, sets, 20, 10)
            digest[name] = _digest(torch, ops.block_topk(*sets[0]))
            print(f"[kernel-ab] {args.label} {name} k={TOPK_K}: "
                  f"{us[name]:.3f} us, outputs {digest[name]}")
            del sets
        for name, windows in (PACK_CELLS.items() if "topk_pack" in groups
                              else ()):
            def make():
                return [torch.randn(windows, cs.PACK_BLOCK, generator=gen,
                                    device="cuda"), TOPK_K]
            sets = _sets(cs, make, windows * cs.PACK_BLOCK * 4)
            us[name] = 1e3 * cs.device_time_ms(ops.wire_topk_pack, sets, 20,
                                               10)
            digest[name] = _digest(torch, ops.wire_topk_pack(*sets[0]))
            print(f"[kernel-ab] {args.label} {name} k={TOPK_K}: "
                  f"{us[name]:.3f} us, outputs {digest[name]}")
            del sets
        for kernel in (SR_KERNELS if "sr" in groups else ()):
            engine, two_step, make, fused = _sr_fns(torch, ops, kernel)
            for plane, tiles in SR_PLANES.items():
                first = make(gen, tiles)
                sets = _sets(cs, lambda: make(gen, tiles),
                             sum(t.nbytes for t in first))
                sets[0] = first
                for form, fn in (("sr", engine), ("sr two-step", two_step)):
                    name = f"{kernel} {form} {plane}"
                    us[name] = 1e3 * cs.device_time_ms(fn, sets, 20, 10,
                                                       cover=True)
                    digest[name] = _digest(torch, fn(*first))
                    print(f"[kernel-ab] {args.label} {name}"
                          f"{' (epilogue)' if fused and fn is engine else ''}"
                          f": {us[name]:.3f} us, outputs {digest[name]}")
                del sets, first
        for name, (windows, levels) in (QSGD_CELLS.items()
                                        if "qsgd" in groups else ()):
            def make():
                x = torch.randn(windows, cs.PACK_BLOCK, generator=gen,
                                device="cuda")
                return [x, torch.rand(x.shape, generator=gen, device="cuda"),
                        levels]
            sets = _sets(cs, make, 2 * windows * cs.PACK_BLOCK * 4)
            us[name] = 1e3 * cs.device_time_ms(ops.wire_qsgd_pack, sets, 20,
                                               10)
            digest[name] = _digest(torch, ops.wire_qsgd_pack(*sets[0]))
            print(f"[kernel-ab] {args.label} {name}: {us[name]:.3f} us, "
                  f"outputs {digest[name]}")
            del sets
        for name, fn, make in (_unpack_cells(torch, ops, ref, cs, gen)
                               if "unpack" in groups else ()):
            first = make()
            nbytes = (sum(t.nbytes for t in first)
                      + first[0].shape[0] * cs.PACK_BLOCK * 4)
            sets = _sets(cs, make, nbytes)
            sets[0] = first
            us[name] = 1e3 * cs.device_time_ms(fn, sets, 20, 10)
            digest[name] = _digest(torch, fn(*first))
            print(f"[kernel-ab] {args.label} {name}: {us[name]:.3f} us, "
                  f"outputs {digest[name]}")
            del sets, first
        for name, (rows, tiles, dt) in (CLIP_CELLS.items()
                                        if "clip" in groups else ()):
            dtype = torch.float32 if dt == "f32" else torch.bfloat16

            def make():
                return [(3 * torch.randn(rows * tiles, cs.TILE, generator=gen,
                                         device="cuda")).to(dtype), rows,
                        1.0]
            sets = _sets(cs, make, 2 * rows * tiles * cs.TILE
                         * (4 if dt == "f32" else 2))
            us[name] = 1e3 * cs.device_time_ms(ops.clip_planes, sets, 20, 10,
                                               cover=True)
            digest[name] = _digest(torch, ops.clip_planes(*sets[0]))
            print(f"[kernel-ab] {args.label} {name} ({rows} x {tiles} tiles): "
                  f"{us[name]:.3f} us, outputs {digest[name]}")
            del sets
    if "dp" in groups:
        from repro_torch.core import clipping
        from repro_torch.models import paper
        shapes = {k: tuple(v.shape) for k, v in
                  paper.mlp_init(seed=0, device="cuda").items()}
        route = _dp_route(clipping)
        for name, (n, b) in DP_CELLS.items():
            lead = (n,) if n > 1 else ()

            def make():
                return [{k: torch.randn((n * b,) + sh, generator=gen,
                                        device="cuda")
                         for k, sh in shapes.items()}, b, n > 1,
                        {k: torch.randn(lead + sh, generator=gen,
                                        device="cuda")
                         for k, sh in shapes.items()}]
            nbytes = 4 * sum(math.prod(sh) for sh in shapes.values()) * (
                n * b + 2 * n)
            sets = _sets(cs, make, nbytes)
            us[name] = 1e3 * cs.device_time_ms(route, sets, 20, 10,
                                               cover=True)
            out = route(*sets[0])
            digest[name] = _digest(torch, tuple(out[k] for k in sorted(out)))
            print(f"[kernel-ab] {args.label} {name} ({n} x {b} samples, "
                  f"{route.__name__} route): {us[name]:.3f} us, outputs "
                  f"{digest[name]}")
            del sets
    prefill = {}
    if args.prefill:
        from repro_torch.launch import serve
        for arch, sc in (("zamba2-7b", cs.ZAMBA_SERVE),
                         ("rwkv6-7b", cs.RWKV_SERVE)):
            prefill[arch] = _prefill(torch, serve, arch, sc, args.label)
    print(json.dumps({"label": args.label, "us": us, "outputs": digest,
                      "prefill_ms": prefill or None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

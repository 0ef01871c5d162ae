"""The decentralized LM training entry point
(``src/repro/launch/train.py``), for any registered algorithm.

``main`` (``python -m repro_torch.launch.train``) builds the model zoo's
``--arch`` (its smoke config under ``--smoke``) and the ``--algo`` of the
registry through :func:`repro_torch.launch.steps.build_train_step`, with
``bundle.loss`` as each agent's loss, and trains it on synthetic token
batches drawn on the device (:func:`repro_torch.data.batch_source`) through
:func:`repro_torch.launch.runtime.run_chunked`: ``--chunk`` rounds between
host syncs, where it logs, checkpoints and stops on a non-finite loss.  It
runs on the card unless ``--device cpu`` is given, and never moves to the
CPU by itself.  It prints the reference's ``[model]``, ``step``,
``[privacy]`` and ``[done]`` lines and exits by the reference's gate: 0
when the last logged loss is finite and fell, or stayed within 2 % of the
first (any finite loss for a DP algorithm).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    python -m repro_torch.launch.train --arch rwkv6-7b --smoke \
        --algo porter-dp --epsilon 0.1 --steps 30

The parts that decide how a run resumes from a checkpoint
(:mod:`repro_torch.launch.checkpoint`), which ``main`` uses and which take
any namespace with ``main``'s fields (``steps``, ``tau``,
``local_samples``, ``epsilon``, ``delta``, ``topology_schedule``,
``plane_dtype``):

* :func:`resolve_privacy` -- ``(sigma_p, accountant, rounds_prev)``: a
  fresh DP run calibrates sigma to its ``steps`` horizon (Theorem 1); a
  resumed one keeps the manifest's sigma and advances the moments
  accountant by the rounds already run, so the printed epsilon covers the
  whole run.
* :func:`check_resume` -- the refusals of a resume under another
  ``topology_schedule`` or another ``plane_dtype`` than the checkpoint's.
* :func:`ckpt_extra` -- the manifest's ``extra`` for a checkpoint taken
  after round ``t_end``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import api
from ..configs import get_config, get_smoke
from ..core.privacy import MomentsAccountant, calibrate_sigma, ldp_epsilon
from ..data import batch_source
from ..tree import tree_leaves
from . import checkpoint
from .runtime import run_chunked
from .steps import build_train_step

__all__ = ["resolve_privacy", "check_resume", "ckpt_extra", "main"]


def resolve_privacy(info, args, start: int, manifest_extra: dict):
    """(sigma_p, accountant, rounds_prev) honoring rounds already spent.

    Fresh DP run: Theorem-1 calibration of sigma for the ``steps``
    horizon.  Resume: sigma comes from the checkpoint manifest (the rounds
    already executed were perturbed with *that* sigma -- re-calibrating as
    if no rounds were spent would silently mis-state the guarantee), and
    the moments accountant is advanced by the manifest's cumulative
    ``rounds_executed`` before a single new round runs.
    """
    rounds_prev = int(manifest_extra.get("rounds_executed", start))
    if not info.dp:
        return 0.0, None, rounds_prev
    sigma_saved = manifest_extra.get("sigma_p")
    if start > 0 and sigma_saved:
        # the accountant describes the mechanism that actually ran: the
        # manifest's tau / local_samples govern it, and changing them on
        # resume would mix rounds clipped/noised under different regimes
        # -- refuse rather than silently mis-state the guarantee
        for knob, arg_val in (("tau", args.tau),
                              ("local_samples", args.local_samples)):
            saved = manifest_extra.get(knob)
            if saved is not None and saved != arg_val:
                raise ValueError(
                    f"--resume with --{knob.replace('_', '-')}={arg_val} "
                    f"but the checkpoint's {rounds_prev} rounds ran with "
                    f"{knob}={saved}; resume with the recorded value (the "
                    "noise was calibrated to it)")
        sigma_p = float(sigma_saved)
        acct = MomentsAccountant(q=1.0 / args.local_samples,
                                 noise_multiplier=sigma_p / args.tau)
        acct.step(rounds_prev)
        print(f"[privacy] resumed: sigma_p={sigma_p:.4g} from the manifest; "
              f"{rounds_prev} rounds already spent, accountant eps so far="
              f"{acct.epsilon(args.delta):.4g}")
    else:
        if start > 0:
            # a DP checkpoint without sigma_p metadata: the spent rounds'
            # noise scale is unknown, so any eps printed would be fiction
            raise ValueError(
                f"--resume of a DP run, but the checkpoint manifest "
                f"records no sigma_p for the {rounds_prev} rounds already "
                "spent (pre-runtime checkpoint?); restart fresh or re-save "
                "the checkpoint with privacy metadata")
        sigma_p = calibrate_sigma(args.tau, args.steps, args.local_samples,
                                  args.epsilon, args.delta)
        acct = MomentsAccountant(q=1.0 / args.local_samples,
                                 noise_multiplier=sigma_p / args.tau)
        acct.step(rounds_prev)
        eps_plan = ldp_epsilon(args.tau, sigma_p, args.steps,
                               args.local_samples, args.delta)
        print(f"[privacy] sigma_p={sigma_p:.4g} for "
              f"({args.epsilon},{args.delta})-LDP over {args.steps} steps; "
              f"accountant eps={eps_plan:.4g}")
    return sigma_p, acct, rounds_prev


def check_resume(args, start: int, rounds_prev: int,
                 manifest_extra: dict) -> None:
    """Refuse a resume (``start > 0``) under another schedule or plane
    dtype than the checkpoint's rounds ran with."""
    # a schedule is part of the trajectory: round t's W_t is picked by the
    # restored step counter, so resuming under a *different* schedule
    # would splice two topologies into one run
    saved_sched = manifest_extra.get("topology_schedule")
    if start > 0 and saved_sched != args.topology_schedule:
        raise ValueError(
            f"--resume with --topology-schedule={args.topology_schedule!r} "
            f"but the checkpoint's {rounds_prev} rounds ran with "
            f"{saved_sched!r}; resume with the recorded schedule (the step "
            "counter continues its period mid-window)")
    # the plane dtype is part of the state layout: restoring the buffers
    # into another one would re-round them outside the SR path
    saved_planes = manifest_extra.get("plane_dtype")
    if start > 0 and saved_planes != args.plane_dtype:
        raise ValueError(
            f"--resume with --plane-dtype={args.plane_dtype!r} but the "
            f"checkpoint's {rounds_prev} rounds ran with "
            f"{saved_planes!r}; resume with the recorded plane dtype")


def ckpt_extra(info, args, sigma_p: float, rounds_prev: int, start: int,
               t_end: int) -> dict:
    """The manifest ``extra`` of a checkpoint after round ``t_end`` of a
    run that started (or resumed) at ``start``."""
    extra = {"rounds_executed": rounds_prev + (t_end - start)}
    if args.topology_schedule is not None:
        extra["topology_schedule"] = args.topology_schedule
    if args.plane_dtype is not None:
        extra["plane_dtype"] = args.plane_dtype
    if info.dp:
        extra.update(sigma_p=sigma_p, tau=args.tau,
                     epsilon=args.epsilon, delta=args.delta,
                     local_samples=args.local_samples)
    return extra


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--algo", default=None,
                    choices=list(api.list_algorithms()),
                    help="registered algorithm (default porter-gc)")
    ap.add_argument("--variant", default=None,
                    choices=sorted(api.VARIANT_TO_ALGO),
                    help="alias for --algo (gc/dp/beer -> porter-*, csgp -> "
                         "dp-csgp)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--chunk", type=int, default=1,
                    help="rounds between host syncs; logging, checkpoints "
                         "and the divergence stop happen at chunk "
                         "boundaries")
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4, help="per-agent batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--topology-schedule", default=None,
                    help="time-varying topology (e.g. "
                         "'dropout:rate=0.2,period=8', "
                         "'rotate:ring+star+complete'); round t mixes with "
                         "W_{t mod period}")
    ap.add_argument("--compressor", default="top_k")
    ap.add_argument("--frac", type=float, default=0.05)
    ap.add_argument("--fleet", action="store_true",
                    help="fleet mode: one agent axis, dense / COO mixing")
    ap.add_argument("--plane-dtype", default=None, choices=["f32", "bf16"],
                    help="EF plane dtype (bf16: f32 master params, "
                         "stochastic-rounding writeback); default f32")
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"],
                    help="remat around the loss and its gradient ('full' "
                         "recomputes everything, 'dots' keeps the dense "
                         "products); default off")
    ap.add_argument("--eta", type=float, default=3e-2)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--epsilon", type=float, default=0.1,
                    help="LDP epsilon target (DP algorithms)")
    ap.add_argument("--delta", type=float, default=1e-3)
    ap.add_argument("--local-samples", type=int, default=4096,
                    help="m: per-agent dataset size (privacy accounting)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def _topology_note(algo, args) -> str:
    if algo.schedule is not None:
        s = algo.schedule
        return (f"{s.kind}, period={s.period}, "
                f"joint gap={1.0 - s.joint_alpha:.3f}, "
                f"per-round alpha={s.alpha:.3f}")
    if algo.topology is not None:
        return f"{args.topology}, alpha={algo.topology.alpha:.3f}"
    return "server/client"


def _write_history(path, history) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(history, indent=2))


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.algo and args.variant:
        ap.error("--algo and --variant are mutually exclusive")
    if args.chunk < 1:
        ap.error("--chunk must be >= 1")
    algo_name = (args.algo or
                 (api.VARIANT_TO_ALGO[args.variant] if args.variant
                  else "porter-gc"))
    info = api.algorithm_info(algo_name)
    device = torch.device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, remat=False)

    # probe the checkpoint before calibrating: a resume keeps the sigma the
    # spent rounds were perturbed with
    start, manifest_extra = 0, {}
    if args.resume and args.ckpt_dir:
        if checkpoint.latest_step(args.ckpt_dir) is not None:
            start = int(checkpoint.latest_step(args.ckpt_dir))
            manifest_extra = checkpoint.read_manifest(
                args.ckpt_dir).get("extra", {})
    sigma_p, acct, rounds_prev = resolve_privacy(info, args, start,
                                                 manifest_extra)
    check_resume(args, start, rounds_prev, manifest_extra)

    setup = build_train_step(
        cfg, args.agents, variant=algo_name, compressor_name=args.compressor,
        frac=args.frac, topology_kind=args.topology,
        topology_schedule=args.topology_schedule, tau=args.tau,
        sigma_p=sigma_p, eta=args.eta, plane_dtype=args.plane_dtype,
        remat_policy=args.remat_policy, fleet=args.fleet, device=device)
    algo = setup.algorithm

    params = setup.bundle.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    mp_note = "".join(
        [f" planes={args.plane_dtype}" if args.plane_dtype else "",
         f" remat={args.remat_policy}" if args.remat_policy else ""])
    print(f"[model] {cfg.name}: {n_params/1e6:.2f}M params, "
          f"{args.agents} agents ({_topology_note(algo, args)}), "
          f"{args.compressor}(rho={args.frac}) algo={algo_name} "
          f"chunk={args.chunk}{mp_note}")

    state = algo.init(params)
    del params
    if start > 0:
        state = checkpoint.restore_state(args.ckpt_dir, like=state)
        print(f"[ckpt] resumed from step {start}")
        if start >= args.steps:
            print(f"[done] checkpoint already at step {start} >= "
                  f"--steps {args.steps}; nothing to train")
            if args.out:   # downstream readers still expect the file
                _write_history(args.out, [])
            return 0

    source = batch_source(cfg, args.agents, args.batch, args.seq,
                          device=device)
    history = []
    run = {"t": start, "diverged": False}
    t0 = time.time()

    def on_chunk(t_start, t_end, st, metrics):
        # one host sync a chunk: the stacked metrics come down together
        m_host = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        wall = round(time.time() - t0, 2)
        for i, t in enumerate(range(t_start, t_end)):
            if t % args.log_every == 0 or t == args.steps - 1:
                m = {k: float(v[i]) for k, v in m_host.items()}
                m["step"] = t
                m["wall_s"] = wall
                history.append(m)
                extra = "".join(
                    f"  {label} {m[k]:.3e}" for k, label in
                    (("consensus_x", "consensus_x"), ("v_norm", "|v|"))
                    if k in m)
                print(f"  step {t:5d}  loss {m['loss']:.4f}{extra}  "
                      f"wire {m['wire_bytes']/1e6:.3f}MB/round  "
                      f"({m['wall_s']}s)")
        run["t"] = t_end
        if not np.isfinite(m_host["loss"][-1]):
            # stop before checkpointing: the last good checkpoint survives
            run["diverged"] = True
            print(f"[diverged] non-finite loss at step {t_end - 1}; "
                  "stopping")
            return False
        if args.ckpt_dir and \
                t_end // args.ckpt_every > t_start // args.ckpt_every:
            checkpoint.save_state(
                args.ckpt_dir, st, step=t_end,
                extra=ckpt_extra(info, args, sigma_p, rounds_prev, start,
                                 t_end))

    run_chunked(algo, source, state, 1, args.steps, chunk=args.chunk,
                start=start, on_chunk=on_chunk, donate=True)

    executed = run["t"] - start
    if acct is not None:
        acct.step(executed)
        print(f"[privacy] executed {executed} rounds this run "
              f"({rounds_prev + executed} cumulative); accountant "
              f"eps={acct.epsilon(args.delta):.4g} at delta={args.delta:g}")
    if args.out:   # written even on divergence
        _write_history(args.out, history)
    if run["diverged"] or not history:
        return 1
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[done] loss {first:.4f} -> {last:.4f} in {executed} steps "
          f"({time.time()-t0:.1f}s)")
    # fail on divergence, not on noise: random tokens keep the loss at its
    # entropy floor, and DP runs are perturbation-dominated
    ok = np.isfinite(last) and (last < first
                                or abs(last - first) <= 0.02 * abs(first))
    return 0 if (ok or (info.dp and np.isfinite(last))) else 1


if __name__ == "__main__":
    raise SystemExit(main())

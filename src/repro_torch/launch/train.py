"""Resume and privacy accounting of a training run.

The parts of ``src/repro/launch/train.py`` that decide how a run resumes
from a checkpoint (:mod:`repro_torch.launch.checkpoint`):

* :func:`resolve_privacy` -- ``(sigma_p, accountant, rounds_prev)``: a
  fresh DP run calibrates sigma to its ``steps`` horizon (Theorem 1); a
  resumed one keeps the manifest's sigma and advances the moments
  accountant by the rounds already run, so the printed epsilon covers the
  whole run.
* :func:`check_resume` -- the refusals of a resume under another
  ``topology_schedule`` or another ``plane_dtype`` than the checkpoint's.
* :func:`ckpt_extra` -- the manifest's ``extra`` for a checkpoint taken
  after round ``t_end``.

``args`` is the reference driver's namespace, or any object with its
fields: ``steps``, ``tau``, ``local_samples``, ``epsilon``, ``delta``,
``topology_schedule`` and ``plane_dtype``.  The LM driver (``main``,
``--arch``) is not ported yet (ROADMAP queue 1 item 13).

    start, extra = 0, {}
    if latest_step(ckpt_dir) is not None:
        start = latest_step(ckpt_dir)
        extra = read_manifest(ckpt_dir).get("extra", {})
    sigma_p, acct, rounds_prev = resolve_privacy(info, args, start, extra)
    check_resume(args, start, rounds_prev, extra)
    ...
    save_state(ckpt_dir, state, step=t_end,
               extra=ckpt_extra(info, args, sigma_p, rounds_prev, start,
                                t_end))
"""

from __future__ import annotations

from ..core.privacy import MomentsAccountant, calibrate_sigma, ldp_epsilon

__all__ = ["resolve_privacy", "check_resume", "ckpt_extra"]


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

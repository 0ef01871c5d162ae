"""Batched serving entry point (``src/repro/launch/serve.py``): prefill a prompt
batch, then greedy-decode N tokens through the family's cache.  The port
serves the rwkv6 family (a recurrent state) and the hybrid one (zamba2:
mamba states plus the shared attention block's key / value caches).

    python -m repro_torch.launch.serve --arch zamba2-7b --batch 4 \\
        --prompt-len 512 --gen 32                 # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --prompt-len 64 --gen 8 --batch 2 --device cpu

It runs on the card unless ``--device cpu`` is given, and never moves to
the CPU by itself.  The parameters are random, drawn on the device from
``--seed``; the prompt from ``--seed + 1``.  Everything runs under
``torch.inference_mode()``.  After prefill the attention caches (``k`` and
``v`` under the cache's ``"attn"``) are grown by ``gen`` positions, chosen
by key: the reference grows every leaf whose axis 2 equals the prompt
length, which also pads a mamba state ``h`` ``(layers, B, H, P, N)`` when
the prompt is as long as there are heads (ROADMAP queue 3).  Prefill and
decode tokens/s are host wall time around work that ends in a device
synchronise; the growth counts to prefill.  The reference's ``remat`` has
no meaning here and is ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from typing import Optional

import torch

from ..configs import get_config, get_smoke
from ..models import build_model
from ..models.model import cast_for_serving

__all__ = ["load", "make_prompt", "grow_cache", "generate", "device_line",
           "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu to "
                           "serve on the CPU")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def load(arch: str, smoke: bool = False, device="cuda", seed: int = 0,
         dtype=None, n_layers: Optional[int] = None):
    """(cfg, bundle, params) of ``arch`` with random parameters drawn on
    ``device`` from ``seed``, stored for serving (``cast_for_serving``).
    ``dtype`` and ``n_layers`` override the config's."""
    device = torch.device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    over = {"remat": False}
    if dtype is not None:
        over["dtype"] = dtype
    if n_layers is not None:
        over["n_layers"] = n_layers
    cfg = dataclasses.replace(cfg, **over)
    bundle = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        params = cast_for_serving(cfg, bundle.init(gen))
    return cfg, bundle, params


def make_prompt(cfg, batch: int, prompt_len: int, device="cuda",
                seed: int = 1):
    """Uniform random token ids ``(batch, prompt_len)`` drawn on ``device``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=device)


def grow_cache(cache, gen: int):
    """``cache`` with its attention caches' ``k`` and ``v`` (``cache["attn"]``,
    stacked ``(groups, B, S, Hk, hd)``) grown by ``gen`` zero positions
    along the sequence axis, so that ``gen`` decode writes fit.  A cache
    without attention (rwkv6) is returned as it is."""
    if "attn" not in cache:
        return cache
    attn = dict(cache["attn"])
    for key in ("k", "v"):
        t = attn[key]
        pad = t.new_zeros(t.shape[:2] + (gen,) + t.shape[3:])
        attn[key] = torch.cat([t, pad], dim=2)
    return dict(cache, attn=attn)


@torch.inference_mode()
def generate(bundle, params, tokens, gen: int):
    """Prefill ``tokens``, then ``gen`` greedy decode steps.

    Returns a dict: ``ids`` ``(B, gen + 1)`` (the prefill's argmax, then
    one id a step), ``prefill_logits`` ``(B, 1, V)``, ``logits`` of the last
    step, ``cache``, and the wall seconds ``prefill_s`` / ``decode_s``,
    each ended by a device synchronise.
    """
    device = tokens.device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, {"tokens": tokens})
    cache = grow_cache(cache, gen)
    _sync(device)
    t1 = time.perf_counter()
    prefill_logits = logits
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    outs = [tok]
    s = tokens.shape[1]
    for i in range(gen):
        logits, cache = bundle.decode_step(params, cache, tok, s + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    return {"ids": torch.cat(outs, dim=1), "prefill_logits": prefill_logits,
            "logits": logits, "cache": cache, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    print(f"[device] {device_line(device)}")
    cfg, bundle, params = load(args.arch, args.smoke, device, args.seed)
    b, s = args.batch, args.prompt_len
    tokens = make_prompt(cfg, b, s, device, args.seed + 1)
    out = generate(bundle, params, tokens, args.gen)
    print(f"[prefill] {cfg.name} batch={b} prompt={s}: "
          f"{out['prefill_s']:.4f} s, {b * s / out['prefill_s']:.1f} tok/s, "
          f"last-token logits {tuple(out['prefill_logits'].shape)}")
    print(f"[decode] {args.gen} tokens x {b} seqs in {out['decode_s']:.4f} s "
          f"({args.gen * b / max(out['decode_s'], 1e-9):.1f} tok/s)")
    ids = out["ids"]
    print("[sample ids]", ids[0, :16].tolist())
    assert bool(torch.all((ids >= 0) & (ids < cfg.vocab)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

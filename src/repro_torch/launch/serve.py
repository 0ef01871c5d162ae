"""Batched serving entry point (``src/repro/launch/serve.py``): prefill a prompt
batch, then greedy-decode N tokens through the family's cache.  The port
serves every architecture of the reference: the dense, MLA and MoE
decoders, the VLM, the encoder-decoder, rwkv6 and the hybrid (zamba2).

    python -m repro_torch.launch.serve --arch minicpm3-4b --batch 4 \\
        --prompt-len 512 --gen 32                 # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --prompt-len 64 --gen 8 --batch 2 --device cpu

It runs on the card unless ``--device cpu`` is given, and never moves to
the CPU by itself.  The parameters are random, drawn on the device from
``--seed``, each leaf cast for serving as it is drawn; the batch
(:func:`make_batch`: tokens, and a VLM's ``patches`` or an encoder-decoder's
``frames``, as the reference builds them) from ``--seed + 1``.  Everything
runs under ``torch.inference_mode()``.  After prefill the attention caches
are grown by ``gen`` positions, chosen by key (:func:`grow_cache`): the
reference grows every leaf whose axis 2 equals the prompt length, which
also pads a mamba state ``h`` ``(layers, B, H, P, N)`` when the prompt is
as long as there are heads, and it grows no cache of the encoder-decoder,
whose decode steps then write one past its self-attention cache (ROADMAP
queue 3).  Prefill and decode tokens/s are host wall time around work
that ends in a device synchronise; the growth counts to prefill.  The
reference's ``remat`` has no meaning here and is ignored.
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
from ..tree import tree_leaves

__all__ = ["load", "serving_dtypes", "make_prompt", "make_batch",
           "grow_cache", "generate", "device_line", "main"]


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


def serving_dtypes(cfg, bundle):
    """The dtype :func:`cast_for_serving` stores each parameter leaf in,
    in the order ``bundle.init`` draws them, found by a draw of the tree's
    shapes alone (meta tensors: no memory, no random numbers)."""
    drawn = []

    def meta(draw, shape, dtype):
        drawn.append(torch.empty(shape, dtype=dtype, device="meta"))
        return drawn[-1]

    tree = bundle.init(torch.Generator(), leaf=meta)
    cast = dict(zip(map(id, tree_leaves(tree)),
                    tree_leaves(cast_for_serving(cfg, tree))))
    return [cast[id(t)].dtype if id(t) in cast else t.dtype for t in drawn]


def load(arch: str, smoke: bool = False, device="cuda", seed: int = 0,
         dtype=None, n_layers: Optional[int] = None,
         n_enc_layers: Optional[int] = None):
    """(cfg, bundle, params) of ``arch`` with random parameters drawn on
    ``device`` from ``seed``, stored for serving: bitwise
    ``cast_for_serving(cfg, bundle.init(generator))``, each leaf cast as
    soon as it is drawn (:func:`serving_dtypes`), so that the whole f32
    model never exists.  ``dtype``, ``n_layers`` and ``n_enc_layers``
    override the config's."""
    device = torch.device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    over = {"remat": False}
    for name, value in (("dtype", dtype), ("n_layers", n_layers),
                        ("n_enc_layers", n_enc_layers)):
        if value is not None:
            over[name] = value
    cfg = dataclasses.replace(cfg, **over)
    bundle = build_model(cfg, device=device)
    dtypes = iter(serving_dtypes(cfg, bundle))
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        params = cast_for_serving(cfg, bundle.init(
            gen, leaf=lambda draw, shape, dt: draw().to(next(dtypes))))
    return cfg, bundle, params


def make_prompt(cfg, batch: int, prompt_len: int, device="cuda",
                seed: int = 1):
    """Uniform random token ids ``(batch, prompt_len)`` drawn on ``device``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=device)


def make_batch(cfg, batch: int, prompt_len: int, device="cuda",
               seed: int = 1):
    """The reference serve entry point's batch for ``cfg``'s family, drawn on
    ``device`` from one generator: a VLM's ``prompt_len - n_prefix`` token
    ids and ``patches`` ``(batch, n_prefix, frontend_dim)``; an
    encoder-decoder's ``frames`` ``(batch, prompt_len, frontend_dim)`` and
    ``prompt_len`` ids; else ``prompt_len`` ids (those of
    :func:`make_prompt` with the same seed).  Embeddings are N(0, 1) f32."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    text = prompt_len - cfg.n_prefix if cfg.family == "vlm" else prompt_len
    if text < 1:
        raise ValueError(f"prompt_len {prompt_len} leaves no text after the "
                         f"{cfg.n_prefix} patch tokens")
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, text),
                                   generator=gen, device=device)}
    extra = {"vlm": ("patches", cfg.n_prefix),
             "encdec": ("frames", prompt_len)}.get(cfg.family)
    if extra is not None:
        out[extra[0]] = torch.randn((batch, extra[1], cfg.frontend_dim),
                                    generator=gen, device=device)
    return out


def _grow(tree, keys, gen: int):
    """``tree`` with its leaves ``keys`` grown by ``gen`` zero positions
    along axis 2 (the sequence axis of a stacked cache)."""
    out = dict(tree)
    for key in keys:
        t = tree[key]
        out[key] = torch.cat(
            [t, t.new_zeros(t.shape[:2] + (gen,) + t.shape[3:])], dim=2)
    return out


def grow_cache(cache, gen: int):
    """``cache`` with room for ``gen`` decode writes, grown by key along
    the sequence axis of its stacked ``(layers or groups, B, S, ...)``
    leaves: the hybrid's ``attn`` ``k`` / ``v``, a decoder's ``k`` / ``v``
    or MLA's ``ckv`` / ``krope``, the encoder-decoder's ``self`` ``k`` /
    ``v`` (never its ``cross`` cache, whose length is the encoder's).  A
    windowed ring cache (``positions``) and a recurrent state (rwkv6) are
    returned as they are."""
    if "positions" in cache or "S" in cache:
        return cache
    if "attn" in cache:
        return dict(cache, attn=grow_cache(cache["attn"], gen))
    if "self" in cache:
        return dict(cache, self=grow_cache(cache["self"], gen))
    return _grow(cache, ("ckv", "krope") if "ckv" in cache else ("k", "v"),
                 gen)


def _prompt_len(batch) -> int:
    """The prefilled positions: the patches and the tokens of a VLM batch,
    the tokens of any other."""
    return batch["tokens"].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)


@torch.inference_mode()
def generate(bundle, params, batch, gen: int):
    """Prefill ``batch`` (a :func:`make_batch` dict, or a token tensor),
    then ``gen`` greedy decode steps at positions ``prompt_len + i``.

    Returns a dict: ``ids`` ``(B, gen + 1)`` (the prefill's argmax, then
    one id a step), ``prefill_logits`` ``(B, 1, V)``, ``logits`` of the last
    step, ``cache``, and the wall seconds ``prefill_s`` / ``decode_s``,
    each ended by a device synchronise.
    """
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    device = batch["tokens"].device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, batch)
    cache = grow_cache(cache, gen)
    _sync(device)
    t1 = time.perf_counter()
    prefill_logits = logits
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    outs = [tok]
    s = _prompt_len(batch)
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
    ap.add_argument("--arch", default="tinyllama-1.1b")
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
    batch = make_batch(cfg, b, s, device, args.seed + 1)
    out = generate(bundle, params, batch, args.gen)
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

"""Model assembly and the ModelBundle API (``src/repro/models/model.py``);
the port builds the ``rwkv6`` and ``hybrid`` (zamba2) families.

A ModelBundle packages what a launcher needs:

    init(generator)            -> params   (drawn on the generator's device)
    forward(params, batch)     -> logits   (B, S, V)
    loss(params, batch)        -> raises: LM training is a later slice
    prefill(params, batch)     -> (last-token logits (B, 1, V), cache)
    init_cache(batch, ...)     -> cache (recurrent state, attention caches)
    decode_step(params, cache, tokens, pos) -> (logits (B, V), cache)

``decode_step`` uses up its ``cache`` argument: the hybrid's attention
caches are written in place (one new slot a step, not a copy of the whole
cache) and the same tensors come back in the returned cache, so keep only
the returned one.  The reference returns an updated copy instead.

Parameters are nested dicts of tensors whose layer leaves are stacked
``(n_layers, ...)``, as in the reference; the layers run in a Python loop
over that axis.  ``batch`` is ``{"tokens": (B, S) int64}``.  The
reference's sharding specs are dropped (one card), so ``init`` returns the
parameters alone.  Call the bundle's functions under
``torch.inference_mode()``: the chunked scans have no backward yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..nn import ssm as S
from ..nn.module import dense, embedding, init_dense, init_embedding
from ..tree import tree_map
from . import blocks as B
from .blocks import ModelConfig

__all__ = ["ModelConfig", "ModelBundle", "build_model", "cast_for_serving"]


@dataclasses.dataclass
class ModelBundle:
    """The family's functions (the module docstring lists them);
    ``decode_step`` uses up its cache argument."""
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable


def _logits(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        table = params["embed"]["table"]
        return x @ table.T.to(x.dtype)
    return dense(params["head"], x)


def _init_common(cfg: ModelConfig, gen: torch.Generator):
    p = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model),
         "final_norm": B._norm_fns(cfg)[0](gen, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["head"] = init_dense(gen, cfg.d_model, cfg.vocab)
    return p


def _positions(b: int, s: int, device=None):
    """(b, s) int32 positions [0, s)."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _layer(layers, i: int):
    return tree_map(lambda leaf: leaf[i], layers)


def _stack(states):
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


# ===========================================================================
# RWKV6 (attention-free; cache = recurrent state)
# ===========================================================================

def _build_rwkv(cfg: ModelConfig, cache_device) -> ModelBundle:
    _, norm = B._norm_fns(cfg)

    def init(generator: torch.Generator):
        p = _init_common(cfg, generator)
        p["layers"] = B.init_rwkv_layer(generator, cfg, lead=(cfg.n_layers,))
        return p

    def _run(params, x, states, apply):
        new_states = []
        for i in range(cfg.n_layers):
            x, st = apply(_layer(params["layers"], i), cfg, x,
                          {k: v[i] for k, v in states.items()})
            new_states.append(st)
        return x, _stack(new_states)

    def init_cache(batch, device=None):
        dev = cache_device if device is None else torch.device(device)
        one = S.init_rwkv6_state(batch, cfg.rwkv_cfg(), device=dev)
        return {k: v.expand((cfg.n_layers,) + v.shape).contiguous()
                for k, v in one.items()}

    def forward(params, batch):
        tokens = batch["tokens"]
        x = embedding(params["embed"], tokens, cfg.dtype)
        states = init_cache(tokens.shape[0], device=tokens.device)
        x, _ = _run(params, x, states, B.rwkv_layer_seq)
        x = norm(params["final_norm"], x)
        return _logits(cfg, params, x)

    def loss(params, batch):
        raise NotImplementedError(
            "the LM loss and training are not ported yet (ROADMAP queue 1 "
            "item 13); the port serves rwkv6: prefill and decode")

    def prefill(params, batch):
        tokens = batch["tokens"]
        x = embedding(params["embed"], tokens, cfg.dtype)
        states = init_cache(tokens.shape[0], device=tokens.device)
        x, new_states = _run(params, x, states, B.rwkv_layer_seq)
        x = norm(params["final_norm"], x[:, -1:])
        return _logits(cfg, params, x), new_states

    def decode_step(params, cache, tokens, pos):
        del pos  # recurrent state carries position implicitly
        x = embedding(params["embed"], tokens, cfg.dtype)
        x, new_states = _run(params, x, cache, B.rwkv_layer_decode)
        x = norm(params["final_norm"], x)
        return _logits(cfg, params, x)[:, 0], new_states

    return ModelBundle(cfg, init, forward, loss, prefill, init_cache,
                       decode_step)


# ===========================================================================
# Hybrid: Mamba2 backbone + ONE shared attention/MLP block applied every k
# layers (zamba2).  The reference scans G groups of k mamba layers, each
# group followed by the shared block, then the trailing mamba layers; the
# port runs the same order in one Python loop.
# ===========================================================================

def _build_hybrid(cfg: ModelConfig, cache_device) -> ModelBundle:
    _, norm = B._norm_fns(cfg)
    g = cfg.attn_every
    n_groups = cfg.n_layers // g   # the trailing n_layers % g skip the block
    acfg = dataclasses.replace(cfg, n_experts=0, mla=False)

    def init(generator: torch.Generator):
        p = _init_common(cfg, generator)
        p["mamba"] = B.init_mamba_layer(generator, cfg, lead=(cfg.n_layers,))
        p["shared_attn"] = B.init_decoder_layer(generator, acfg)
        return p

    def _run(params, x, mamba_states, positions, attn_ctx):
        """attn_ctx: None (fresh forward), "collect" (prefill: gather the
        shared block's caches), or the stacked caches (decode: one token;
        each group's cache is updated in place).  Returns (x, the stacked
        mamba states, the collected caches)."""
        decode = isinstance(attn_ctx, dict)
        apply = B.mamba_layer_decode if decode else B.mamba_layer_seq
        shared = params["shared_attn"]
        states, caches = [], []
        for i in range(cfg.n_layers):
            x, st = apply(_layer(params["mamba"], i), cfg, x,
                          {k: v[i] for k, v in mamba_states.items()})
            states.append(st)
            if (i + 1) % g:
                continue
            if decode:
                gi = (i + 1) // g - 1
                x, _ = B.decoder_layer_decode(
                    shared, acfg, x, {k: v[gi] for k, v in attn_ctx.items()},
                    positions)
            else:
                x, cache, _ = B.decoder_layer_seq(
                    shared, acfg, x, positions,
                    collect_cache=attn_ctx == "collect",
                    cache_dtype=cfg.dtype)
                caches.append(cache)
        return x, _stack(states), caches

    def _mamba_cache(batch, device):
        one = S.init_mamba2_state(batch, cfg.mamba_cfg(), device=device)
        return {k: v.expand((cfg.n_layers,) + v.shape).contiguous()
                for k, v in one.items()}

    def init_cache(batch, cache_len, dtype=torch.bfloat16, window="cfg",
                   device=None):
        """Zero mamba states ``(n_layers, ...)`` and attention caches
        ``(n_groups, ...)`` of ``cache_len`` positions (a ring of the
        window's size where the window is shorter)."""
        dev = cache_device if device is None else torch.device(device)
        one = B.init_decoder_cache(acfg, batch, cache_len, dtype, window, dev)
        attn = {k: v.expand((n_groups,) + v.shape).contiguous()
                for k, v in one.items()}
        return {"mamba": _mamba_cache(batch, dev), "attn": attn}

    def forward(params, batch):
        tokens = batch["tokens"]
        x = embedding(params["embed"], tokens, cfg.dtype)
        pos = _positions(*tokens.shape[:2], device=tokens.device)
        x, _, _ = _run(params, x, _mamba_cache(tokens.shape[0],
                                               tokens.device), pos, None)
        x = norm(params["final_norm"], x)
        return _logits(cfg, params, x)

    def loss(params, batch):
        raise NotImplementedError(
            "the LM loss and training are not ported yet (ROADMAP queue 1 "
            "item 13); the port serves hybrid models: prefill and decode")

    def prefill(params, batch):
        tokens = batch["tokens"]
        x = embedding(params["embed"], tokens, cfg.dtype)
        pos = _positions(*tokens.shape[:2], device=tokens.device)
        x, states, caches = _run(params, x, _mamba_cache(tokens.shape[0],
                                                         tokens.device),
                                 pos, "collect")
        x = norm(params["final_norm"], x[:, -1:])
        return _logits(cfg, params, x), {"mamba": states,
                                         "attn": _stack(caches)}

    def decode_step(params, cache, tokens, pos):
        """Uses up ``cache``: its attention tensors are written in place and
        come back in the returned cache."""
        x = embedding(params["embed"], tokens, cfg.dtype)
        x, states, _ = _run(params, x, cache["mamba"], pos, cache["attn"])
        x = norm(params["final_norm"], x)
        return _logits(cfg, params, x)[:, 0], {"mamba": states,
                                               "attn": cache["attn"]}

    return ModelBundle(cfg, init, forward, loss, prefill, init_cache,
                       decode_step)


# ===========================================================================

_BUNDLES = {
    "rwkv6": _build_rwkv,
    "hybrid": _build_hybrid,
}


def build_model(cfg: ModelConfig, device=None) -> ModelBundle:
    """The bundle of ``cfg``; ``device`` (cuda unless given) is where
    ``init_cache`` puts a cache when it is not told otherwise."""
    if cfg.family not in B.FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family not in _BUNDLES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP queue 1 "
            f"item 13); the port builds {sorted(_BUNDLES)}")
    device = torch.device("cuda") if device is None else torch.device(device)
    return _BUNDLES[cfg.family](cfg, device)


# per family, the leaves the reference reads only through
# ``.astype(cfg.dtype)``, by their path: every dense ``w`` (and ``b``:
# ``dense`` casts both); rwkv6's token-shift lerps ``mu`` / ``mu_c``; the
# mamba conv's ``conv_w`` / ``conv_b`` (``_causal_conv`` casts both to the
# activations' dtype).  The embedding table (``embedding`` casts the
# gathered rows, ``_logits`` the table) and an untied head are cast for
# every family.
_CAST = {
    "rwkv6": {"layers": {"blk": ("wr", "wk", "wv", "wg", "wo", "w_lora_a",
                                 "w_lora_b", "ck", "cr", "cv", "mu",
                                 "mu_c")}},
    "hybrid": {"mamba": {"blk": ("w_in", "w_out", "conv_w", "conv_b")},
               "shared_attn": {"attn": ("wq", "wk", "wv", "wo"),
                               "ffn": ("w_in", "w_gate", "w_out")}},
}


def _cast_named(tree, spec, dt):
    out = dict(tree)
    if isinstance(spec, dict):
        for key, sub in spec.items():
            out[key] = _cast_named(tree[key], sub, dt)
        return out
    for name in spec:
        if name in out:
            out[name] = tree_map(lambda t: t.to(dt), tree[name])
    return out


def cast_for_serving(cfg: ModelConfig, params):
    """A copy of ``params`` whose read-as-``cfg.dtype`` leaves are stored in
    ``cfg.dtype`` (:data:`_CAST`: the dense weights, rwkv6's lerps, the
    mamba conv, the embedding table and an untied head's weight).  Every
    use of those leaves casts them to ``cfg.dtype`` first, and a cast of a
    cast is the same cast, so the model's outputs are bitwise those of the
    f32 parameters; decode then reads half the bytes and skips one cast per
    use.  The leaves read in f32 (rwkv6's ``w0`` / ``u``, mamba's
    ``a_log`` / ``dt_bias`` / ``d_skip``, the norms) stay f32.  The result
    shares the untouched leaves with ``params``.
    """
    dt = cfg.dtype
    out = _cast_named(params, _CAST[cfg.family], dt)
    out["embed"] = {"table": params["embed"]["table"].to(dt)}
    if "head" in params:
        out["head"] = {k: v.to(dt) for k, v in params["head"].items()}
    return out

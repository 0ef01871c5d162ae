"""Model assembly and the ModelBundle API (``src/repro/models/model.py``);
this slice builds the ``rwkv6`` family.

A ModelBundle packages what a launcher needs:

    init(generator)            -> params   (drawn on the generator's device)
    forward(params, batch)     -> logits   (B, S, V)
    loss(params, batch)        -> raises: LM training is a later slice
    prefill(params, batch)     -> (last-token logits (B, 1, V), cache)
    init_cache(batch)          -> cache (the recurrent state, stacked)
    decode_step(params, cache, tokens, pos) -> (logits (B, V), cache)

Parameters are nested dicts of tensors whose layer leaves are stacked
``(n_layers, ...)``, as in the reference; the layers run in a Python loop
over that axis.  ``batch`` is ``{"tokens": (B, S) int64}``.  The
reference's sharding specs are dropped (one card), so ``init`` returns the
parameters alone.  Call the bundle's functions under
``torch.inference_mode()``: the chunked scan has no backward yet.
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

_BUNDLES = {
    "rwkv6": _build_rwkv,
}


def build_model(cfg: ModelConfig, device=None) -> ModelBundle:
    """The bundle of ``cfg``; ``device`` (cuda unless given) is where
    ``init_cache`` puts a cache when it is not told otherwise."""
    if cfg.family not in B.FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family not in _BUNDLES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP queue 1 "
            "item 13); the port builds rwkv6")
    device = torch.device("cuda") if device is None else torch.device(device)
    return _BUNDLES[cfg.family](cfg, device)


# the leaves the reference reads only through ``.astype(cfg.dtype)``: every
# dense ``w`` (``dense``), the token-shift lerps ``mu`` / ``mu_c``, and the
# embedding table (``embedding`` casts the gathered rows, ``_logits`` the
# table)
_CAST_DENSE = ("wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b", "ck",
               "cr", "cv")


def cast_for_serving(cfg: ModelConfig, params):
    """A copy of ``params`` whose read-as-``cfg.dtype`` leaves are stored in
    ``cfg.dtype``: the dense weights, ``mu``, ``mu_c``, the embedding table
    (and an untied head's weight).  Every use of those leaves casts them to
    ``cfg.dtype`` first (``dense``, ``embedding``, ``_logits``, the lerps),
    and a cast of a cast is the same cast, so the model's outputs are
    bitwise those of the f32 parameters; decode then reads half the bytes
    and skips one cast per use.  The leaves read in f32 (``w0``, ``u``, the
    norms) stay f32.  The result shares the untouched leaves with
    ``params``.
    """
    dt = cfg.dtype
    blk = dict(params["layers"]["blk"])
    for name in _CAST_DENSE:
        blk[name] = {k: v.to(dt) for k, v in blk[name].items()}
    for name in ("mu", "mu_c"):
        blk[name] = blk[name].to(dt)
    out = dict(params)
    out["layers"] = dict(params["layers"], blk=blk)
    out["embed"] = {"table": params["embed"]["table"].to(dt)}
    if "head" in params:
        out["head"] = {k: v.to(dt) for k, v in params["head"].items()}
    return out

"""Model assembly and the ModelBundle API (``src/repro/models/model.py``),
for every family: the dense / MoE / VLM decoder, rwkv6, the hybrid
(zamba2) and the encoder-decoder (seamless).

A ModelBundle packages what a launcher needs:

    init(generator, leaf=None) -> params   (drawn on the generator's device)
    forward(params, batch)     -> logits   (B, S, V)
    loss(params, batch)        -> scalar   (next-token cross-entropy)
    prefill(params, batch)     -> (last-token logits (B, 1, V), cache)
    init_cache(batch, ...)     -> an empty cache of the family's format
    decode_step(params, cache, tokens, pos) -> (logits (B, V), cache)

``decode_step`` uses up its ``cache`` argument: the attention caches (and
MLA's latent) are written in place (one new slot a step, not a copy of the
whole cache) and the same tensors come back in the returned cache, so keep
only the returned one.  The reference returns an updated copy instead.

Parameters are nested dicts of tensors whose layer leaves are stacked
``(n_layers, ...)``, as in the reference; the layers run in a Python loop
over that axis.  ``init``'s ``leaf`` is the hook of a
:class:`repro_torch.nn.module.Hooked` draw.  Batches, as in the reference:

    dense / moe / rwkv6 / hybrid : {"tokens": (B, S)}
    vlm    : {"tokens": (B, S - n_prefix), "patches": (B, n_prefix, F)}
    encdec : {"frames": (B, S_enc, F), "tokens": (B, S_dec)}

The modality frontends are stubs, as in the reference: ``patches`` and
``frames`` arrive as precomputed embeddings.  ``init`` returns the
parameters alone; each leaf's reference PartitionSpec comes from
:func:`repro_torch.nn.module.leaf_specs` (the embedding and an untied head
vocab-parallel when the vocab divides by :data:`MODEL_AXIS_SIZE`, as in
the reference).

Tensor parallelism (``build_model(cfg, group=)``, the group's
``model_size`` M > 1), for every family: the bundle holds this rank's
shard of every sharded leaf (``init`` draws each full leaf and keeps the
slice, so the shards are the one-card parameters') and its ``loss`` runs
tensor-parallel (:mod:`repro_torch.nn.tensor_parallel`): the decoder
(dense GQA or MLA, MoE ffn- or expert-parallel, the VLM), rwkv6, the
hybrid (Mamba2 layers and the shared block) and the encoder-decoder (the
encoder, the cross-attention decoder), the embedding and the head tied or
not, vocab-parallel or d_model-sharded by the reference's rule.  Each
family's builder takes ``model`` and there is one ``loss`` a family; such
a bundle trains and does not serve.

``loss`` is the reference's: the mean next-token cross-entropy of
``forward``'s logits (a decoder's plus ``0.01 * aux / n_layers``, the MoE
load-balance term; a VLM scores only its text positions).  It runs the
scans of rwkv6 and the hybrid in their plain chunked form (``plain_scan``),
which ``torch.func`` differentiates, as the reference trains through its
jnp chunked scans; ``forward`` and ``prefill`` keep the kernels.  Call
``forward``, ``prefill`` and ``decode_step`` under
``torch.inference_mode()``: the scan kernels have no backward.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ..nn import ssm as S
from ..nn import tensor_parallel as TP
from ..nn.module import (Hooked, cross_entropy_loss, dense, embedding,
                         init_dense, init_embedding, leaf_specs)
from ..tree import tree_map
from . import blocks as B
from .blocks import ModelConfig

__all__ = ["ModelConfig", "ModelBundle", "build_model", "cast_for_serving",
           "MODEL_AXIS_SIZE", "vocab_parallel"]


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


# The reference's production tensor-parallel axis size: the embedding and
# an untied head are vocab-parallel when the vocab divides by it, else
# their d_model axis is sharded (vocab 73,448, 256,206, 257,216).
MODEL_AXIS_SIZE = 16


def vocab_parallel(cfg: ModelConfig) -> bool:
    """The reference's rule: shard the vocab when it divides by
    :data:`MODEL_AXIS_SIZE`."""
    return cfg.vocab % MODEL_AXIS_SIZE == 0


def _init_common(cfg: ModelConfig, gen: torch.Generator):
    vocab_ok = vocab_parallel(cfg)
    p = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                 spec=("model", None) if vocab_ok
                                 else (None, "model")),
         "final_norm": B._norm_fns(cfg)[0](gen, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["head"] = init_dense(gen, cfg.d_model, cfg.vocab,
                               spec=(None, "model") if vocab_ok
                               else ("model", None))
    return p


def _positions(b: int, s: int, device=None):
    """(b, s) int32 positions [0, s)."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _layer(layers, i: int):
    return tree_map(lambda leaf: leaf[i], layers)


def _stack(states):
    """A list of per-layer dicts (or dicts of dicts) stacked leafwise."""
    return {k: (_stack([st[k] for st in states])
                if isinstance(states[0][k], dict) else
                torch.stack([st[k] for st in states])) for k in states[0]}


def _at(tree, i: int):
    """Layer ``i``'s views of a stacked cache (writes reach the stack)."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _repeat(one, n: int):
    """A one-layer cache repeated into a stack of ``n``."""
    return {k: _repeat(v, n) if isinstance(v, dict) else
            v.expand((n,) + v.shape).contiguous() for k, v in one.items()}


def _lm_loss(logits, tokens):
    """The next-token loss: position t's logits score token t + 1."""
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])


def _cache_dev(default, device):
    return default if device is None else torch.device(device)


def _embed(cfg: ModelConfig, params, tokens, model):
    """The token embeddings; on a model axis vocab-parallel or
    d_model-sharded by the reference's rule (:func:`vocab_parallel`)."""
    if model is None:
        return embedding(params["embed"], tokens, cfg.dtype)
    embed = TP.embedding if vocab_parallel(cfg) else TP.embedding_columns
    return embed(params["embed"], tokens, model, cfg.dtype)


def _head_loss(cfg: ModelConfig, params, x, tokens, model):
    """The next-token loss of the head over the normalised ``x`` (the
    vocab-parallel cross-entropy on a model axis where the logits are
    vocab-sharded)."""
    if model is None:
        return _lm_loss(_logits(cfg, params, x), tokens)
    z, sharded = _tp_logits(cfg, params, x, model)
    if sharded:
        return TP.cross_entropy_loss(z[:, :-1], tokens[:, 1:], model)
    return _lm_loss(z, tokens)


# ===========================================================================
# dense / moe decoder (also the vlm text stack)
# ===========================================================================

def _build_decoder(cfg: ModelConfig, cache_device, model=None
                   ) -> ModelBundle:
    """The decoder bundle; ``model``: a group with a model axis, whose
    ``params`` are this rank's shards and whose embedding, layers and head
    run tensor-parallel (:func:`_tensor_parallel` wraps the bundle)."""
    _, norm = B._norm_fns(cfg)
    is_vlm = cfg.family == "vlm"
    mode = "prefix" if is_vlm else "causal"

    def init(generator: torch.Generator):
        p = _init_common(cfg, generator)
        p["layers"] = B.init_decoder_layer(generator, cfg,
                                           lead=(cfg.n_layers,))
        if is_vlm:
            p["projector"] = init_dense(generator, cfg.frontend_dim,
                                        cfg.d_model, spec=(None, None))
        return p

    def _embed_inputs(params, batch):
        """The input embeddings (the VLM's projected patches first, the
        projector replicated on a model axis) and the prefix length."""
        x = _embed(cfg, params, batch["tokens"], model)
        if not is_vlm:
            return x, 0
        patches = dense(params["projector"], batch["patches"].to(cfg.dtype))
        return torch.cat([patches, x], dim=1), cfg.n_prefix

    def _run_layers(params, x, prefix_len, collect, window):
        """Returns (x, the stacked caches or None, the summed MoE loss)."""
        pos = _positions(*x.shape[:2], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for i in range(cfg.n_layers):
            x, cache, a = B.decoder_layer_seq(
                _layer(params["layers"], i), cfg, x, pos, mode, prefix_len,
                collect_cache=collect, cache_dtype=cfg.dtype, window=window,
                model=model)
            aux = aux + a
            caches.append(cache)
        return x, (_stack(caches) if collect else None), aux

    def forward(params, batch):
        x, prefix_len = _embed_inputs(params, batch)
        x, _, _ = _run_layers(params, x, prefix_len, False, "cfg")
        return _logits(cfg, params, norm(params["final_norm"], x))

    def loss(params, batch):
        x, prefix_len = _embed_inputs(params, batch)
        x, _, aux = _run_layers(params, x, prefix_len, False, "cfg")
        x = norm(params["final_norm"], x)
        if is_vlm:   # only the text positions predict
            x = x[:, cfg.n_prefix:]
        return (_head_loss(cfg, params, x, batch["tokens"], model)
                + 0.01 * aux / max(cfg.n_layers, 1))

    def prefill(params, batch, window="cfg"):
        x, prefix_len = _embed_inputs(params, batch)
        x, caches, _ = _run_layers(params, x, prefix_len, True, window)
        x = norm(params["final_norm"], x[:, -1:])
        return _logits(cfg, params, x), caches

    def init_cache(batch, cache_len, dtype=torch.bfloat16, window="cfg",
                   device=None):
        """Zero caches ``(n_layers, ...)`` of ``cache_len`` positions: the
        MLA latent, or GQA keys and values (a ring of the window's size
        where the window is shorter)."""
        one = B.init_decoder_cache(cfg, batch, cache_len, dtype, window,
                                   _cache_dev(cache_device, device))
        return _repeat(one, cfg.n_layers)

    def decode_step(params, cache, tokens, pos, window="cfg"):
        """Uses up ``cache``: its tensors are written in place and come
        back as the returned cache."""
        x = embedding(params["embed"], tokens, cfg.dtype)   # (B,1,D)
        for i in range(cfg.n_layers):
            x, _ = B.decoder_layer_decode(_layer(params["layers"], i), cfg,
                                          x, _at(cache, i), pos,
                                          window=window)
        x = norm(params["final_norm"], x)
        return _logits(cfg, params, x)[:, 0], cache

    return ModelBundle(cfg, init, forward, loss, prefill, init_cache,
                       decode_step)


# ===========================================================================
# RWKV6 (attention-free; cache = recurrent state)
# ===========================================================================

def _build_rwkv(cfg: ModelConfig, cache_device, model=None) -> ModelBundle:
    """The rwkv6 bundle; ``model`` as in :func:`_build_decoder` (each
    layer's block tensor-parallel, :func:`repro_torch.nn.ssm.rwkv6_block`)."""
    _, norm = B._norm_fns(cfg)

    def init(generator: torch.Generator):
        p = _init_common(cfg, generator)
        p["layers"] = B.init_rwkv_layer(generator, cfg, lead=(cfg.n_layers,))
        return p

    def _run(params, x, states, apply):
        new_states = []
        for i in range(cfg.n_layers):
            x, st = apply(_layer(params["layers"], i), cfg, x,
                          _at(states, i))
            new_states.append(st)
        return x, _stack(new_states)

    def _hidden(params, batch, plain_scan):
        """The final-normed hidden states from fresh states."""
        tokens = batch["tokens"]
        x = _embed(cfg, params, tokens, model)
        states = init_cache(tokens.shape[0], device=tokens.device)
        x, _ = _run(params, x, states, functools.partial(
            B.rwkv_layer_seq, plain_scan=plain_scan, model=model))
        return norm(params["final_norm"], x)

    def init_cache(batch, device=None):
        one = S.init_rwkv6_state(batch, cfg.rwkv_cfg(),
                                 device=_cache_dev(cache_device, device))
        return _repeat(one, cfg.n_layers)

    def forward(params, batch):
        return _logits(cfg, params, _hidden(params, batch, False))

    def loss(params, batch):
        return _head_loss(cfg, params, _hidden(params, batch, True),
                          batch["tokens"], model)

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

def _build_hybrid(cfg: ModelConfig, cache_device, model=None
                  ) -> ModelBundle:
    """The hybrid bundle; ``model`` as in :func:`_build_decoder` (the
    Mamba2 layers tensor-parallel, :func:`repro_torch.nn.ssm.mamba2_block`,
    and the shared block as a decoder layer's)."""
    _, norm = B._norm_fns(cfg)
    g = cfg.attn_every
    n_groups = cfg.n_layers // g   # the trailing n_layers % g skip the block
    acfg = dataclasses.replace(cfg, n_experts=0, mla=False)

    def init(generator: torch.Generator):
        p = _init_common(cfg, generator)
        p["mamba"] = B.init_mamba_layer(generator, cfg, lead=(cfg.n_layers,))
        p["shared_attn"] = B.init_decoder_layer(generator, acfg)
        return p

    def _run(params, x, mamba_states, positions, attn_ctx, window="cfg",
             plain_scan=False):
        """attn_ctx: None (fresh forward), "collect" (prefill: gather the
        shared block's caches), or the stacked caches (decode: one token;
        each group's cache is updated in place).  Returns (x, the stacked
        mamba states, the collected caches)."""
        decode = isinstance(attn_ctx, dict)
        apply = (B.mamba_layer_decode if decode else
                 functools.partial(B.mamba_layer_seq, plain_scan=plain_scan,
                                   model=model))
        shared = params["shared_attn"]
        states, caches = [], []
        for i in range(cfg.n_layers):
            x, st = apply(_layer(params["mamba"], i), cfg, x,
                          _at(mamba_states, i))
            states.append(st)
            if (i + 1) % g:
                continue
            if decode:
                gi = (i + 1) // g - 1
                x, _ = B.decoder_layer_decode(
                    shared, acfg, x, _at(attn_ctx, gi), positions,
                    window=window)
            else:
                x, cache, _ = B.decoder_layer_seq(
                    shared, acfg, x, positions,
                    collect_cache=attn_ctx == "collect",
                    cache_dtype=cfg.dtype, window=window, model=model)
                caches.append(cache)
        return x, _stack(states), caches

    def _mamba_cache(batch, device):
        one = S.init_mamba2_state(batch, cfg.mamba_cfg(), device=device)
        return _repeat(one, cfg.n_layers)

    def init_cache(batch, cache_len, dtype=torch.bfloat16, window="cfg",
                   device=None):
        """Zero mamba states ``(n_layers, ...)`` and attention caches
        ``(n_groups, ...)`` of ``cache_len`` positions (a ring of the
        window's size where the window is shorter)."""
        dev = _cache_dev(cache_device, device)
        one = B.init_decoder_cache(acfg, batch, cache_len, dtype, window, dev)
        return {"mamba": _mamba_cache(batch, dev),
                "attn": _repeat(one, n_groups)}

    def _hidden(params, batch, plain_scan):
        """The final-normed hidden states from fresh states."""
        tokens = batch["tokens"]
        x = _embed(cfg, params, tokens, model)
        pos = _positions(*tokens.shape[:2], device=tokens.device)
        x, _, _ = _run(params, x, _mamba_cache(tokens.shape[0],
                                               tokens.device), pos, None,
                       plain_scan=plain_scan)
        return norm(params["final_norm"], x)

    def forward(params, batch):
        return _logits(cfg, params, _hidden(params, batch, False))

    def loss(params, batch):
        return _head_loss(cfg, params, _hidden(params, batch, True),
                          batch["tokens"], model)

    def prefill(params, batch, window="cfg"):
        tokens = batch["tokens"]
        x = embedding(params["embed"], tokens, cfg.dtype)
        pos = _positions(*tokens.shape[:2], device=tokens.device)
        x, states, caches = _run(params, x, _mamba_cache(tokens.shape[0],
                                                         tokens.device),
                                 pos, "collect", window)
        x = norm(params["final_norm"], x[:, -1:])
        return _logits(cfg, params, x), {"mamba": states,
                                         "attn": _stack(caches)}

    def decode_step(params, cache, tokens, pos, window="cfg"):
        """Uses up ``cache``: its attention tensors are written in place and
        come back in the returned cache."""
        x = embedding(params["embed"], tokens, cfg.dtype)
        x, states, _ = _run(params, x, cache["mamba"], pos, cache["attn"],
                            window)
        x = norm(params["final_norm"], x)
        return _logits(cfg, params, x)[:, 0], {"mamba": states,
                                               "attn": cache["attn"]}

    return ModelBundle(cfg, init, forward, loss, prefill, init_cache,
                       decode_step)


# ===========================================================================
# Encoder-decoder (seamless-m4t): audio frames -> encoder; text decoder with
# cross-attention.
# ===========================================================================

def _build_encdec(cfg: ModelConfig, cache_device, model=None
                  ) -> ModelBundle:
    """The encoder-decoder bundle; ``model`` as in :func:`_build_decoder`
    (the adapter replicated, the encoder and decoder layers
    tensor-parallel, the cross-attention's keys and values over the
    replicated encoder output)."""
    _, norm = B._norm_fns(cfg)

    def init(generator: torch.Generator):
        p = _init_common(cfg, generator)
        p["adapter"] = init_dense(generator, cfg.frontend_dim, cfg.d_model,
                                  spec=(None, None))
        p["enc_layers"] = B.init_encoder_layer(generator, cfg,
                                               lead=(cfg.n_enc_layers,))
        p["dec_layers"] = B.init_xattn_decoder_layer(generator, cfg,
                                                     lead=(cfg.n_layers,))
        return p

    def _encode(params, frames):
        x = dense(params["adapter"], frames.to(cfg.dtype))
        pos = _positions(*x.shape[:2], device=x.device)
        for i in range(cfg.n_enc_layers):
            x = B.encoder_layer_seq(_layer(params["enc_layers"], i), cfg, x,
                                    pos, model=model)
        return x

    def _decode_seq(params, tokens, enc_out, collect):
        x = _embed(cfg, params, tokens, model)
        pos = _positions(*tokens.shape[:2], device=tokens.device)
        caches = []
        for i in range(cfg.n_layers):
            x, cache = B.xattn_decoder_layer_seq(
                _layer(params["dec_layers"], i), cfg, x, pos, enc_out,
                collect_cache=collect, cache_dtype=cfg.dtype, model=model)
            caches.append(cache)
        return x, (_stack(caches) if collect else None)

    def _hidden(params, batch):
        enc_out = _encode(params, batch["frames"])
        x, _ = _decode_seq(params, batch["tokens"], enc_out, False)
        return norm(params["final_norm"], x)

    def forward(params, batch):
        return _logits(cfg, params, _hidden(params, batch))

    def loss(params, batch):
        return _head_loss(cfg, params, _hidden(params, batch),
                          batch["tokens"], model)

    def prefill(params, batch):
        enc_out = _encode(params, batch["frames"])
        x, caches = _decode_seq(params, batch["tokens"], enc_out, True)
        x = norm(params["final_norm"], x[:, -1:])
        return _logits(cfg, params, x), caches

    def init_cache(batch, cache_len, dtype=torch.bfloat16, enc_len=None,
                   device=None):
        """Zero ``{"self", "cross"}`` caches ``(n_layers, ...)``: the self
        cache of ``cache_len`` positions, the cross one of ``enc_len``
        (``cache_len`` unless given)."""
        one = B.init_xattn_cache(cfg, batch, cache_len, enc_len or cache_len,
                                 dtype, _cache_dev(cache_device, device))
        return _repeat(one, cfg.n_layers)

    def decode_step(params, cache, tokens, pos):
        """Uses up ``cache``: its self-attention tensors are written in
        place and come back in the returned cache."""
        x = embedding(params["embed"], tokens, cfg.dtype)
        for i in range(cfg.n_layers):
            x, _ = B.xattn_decoder_layer_decode(
                _layer(params["dec_layers"], i), cfg, x, _at(cache, i), pos)
        x = norm(params["final_norm"], x)
        return _logits(cfg, params, x)[:, 0], cache

    return ModelBundle(cfg, init, forward, loss, prefill, init_cache,
                       decode_step)


# ===========================================================================

_BUNDLES = {
    "dense": _build_decoder,
    "moe": _build_decoder,
    "vlm": _build_decoder,
    "rwkv6": _build_rwkv,
    "hybrid": _build_hybrid,
    "encdec": _build_encdec,
}


def _hooked(init):
    """``init(generator, leaf=None, with_spec=False)``: the family's draw,
    each leaf through ``leaf`` when given
    (:class:`repro_torch.nn.module.Hooked`)."""
    def hooked(generator: torch.Generator, leaf=None, with_spec=False):
        return init(generator if leaf is None
                    else Hooked(generator, leaf, with_spec))
    return hooked


def _tp_logits(cfg: ModelConfig, params, x, model):
    """The head over the replicated ``x`` on a model axis: ``(logits,
    vocab-sharded)``.  Vocab-parallel (the vocab divides by
    :data:`MODEL_AXIS_SIZE`): this rank's vocab columns, from the tied
    table's rows or the untied head's columns.  d_model-sharded: this
    rank's slice of ``x`` times its rows of the head (the tied table's
    columns), summed over the model axis into whole logits."""
    head = ({"w": params["embed"]["table"].T} if cfg.tie_embeddings
            else params["head"])
    if vocab_parallel(cfg):
        return TP.column_dense(head, x, model), True
    return TP.row_dense(head, TP.slice_for_model(x, model), model), False


def _tensor_parallel(cfg: ModelConfig, device, model) -> ModelBundle:
    """The family's bundle on a model axis: ``init`` keeps this rank's
    shard of every leaf drawn, ``loss`` is the family builder's over
    ``model`` (the embedding vocab-parallel or d_model-sharded, tied or
    not); serving refuses."""
    bundle = _BUNDLES[cfg.family](cfg, device, model)
    plain_init = _hooked(bundle.init)

    def init(generator, leaf=None, with_spec=False):
        if with_spec:
            return plain_init(generator, leaf, with_spec=True)
        return plain_init(generator, TP.shard_hook(model, leaf),
                          with_spec=True)

    def serving(*args, **kwargs):
        raise ValueError("a tensor-parallel bundle trains; the port serves "
                         "one replica on one card (build without group=)")

    tp = ModelBundle(cfg, init, serving, bundle.loss, serving, serving,
                     serving)
    TP.check_shardable(leaf_specs(tp), model.model_size)
    TP.local_heads(cfg.n_heads, cfg.n_heads if cfg.mla else cfg.n_kv_heads,
                   model)
    return tp


def build_model(cfg: ModelConfig, device=None, group=None) -> ModelBundle:
    """The bundle of ``cfg``; ``device`` (cuda unless given) is where
    ``init_cache`` puts a cache when it is not told otherwise.  ``group``:
    an agent group; with a model axis (``model_size > 1``) the family's
    tensor-parallel bundle of this rank's shard."""
    if cfg.family not in _BUNDLES:
        raise ValueError(f"unknown family {cfg.family!r}")
    device = torch.device("cuda") if device is None else torch.device(device)
    if group is not None and getattr(group, "model_size", 1) > 1:
        return _tensor_parallel(cfg, device, group)
    bundle = _BUNDLES[cfg.family](cfg, device)
    return dataclasses.replace(bundle, init=_hooked(bundle.init))


# per family, the leaves the reference reads only through
# ``.astype(cfg.dtype)``, by their path: every dense ``w`` (and ``b``:
# ``dense`` casts both) but the MoE router's, which reads f32 activations;
# the expert stacks (``.astype(buf.dtype)``); rwkv6's token-shift lerps
# ``mu`` / ``mu_c``; the mamba conv's ``conv_w`` / ``conv_b``
# (``_causal_conv`` casts both to the activations' dtype).  The embedding
# table (``embedding`` casts the gathered rows, ``_logits`` the table) and
# an untied head are cast for every family.
_GQA = ("wq", "wk", "wv", "wo")
_MLA = ("wdq", "wuq", "wdkv", "wuk", "wuv", "wo")
_FFN = ("w_in", "w_gate", "w_out", "dense_mlp")
_DECODER = {"layers": {"attn": _GQA + _MLA, "ffn": _FFN},
            "projector": ("w", "b")}
_CAST = {
    "dense": _DECODER,
    "moe": _DECODER,
    "vlm": _DECODER,
    "encdec": {"adapter": ("w", "b"),
               "enc_layers": {"attn": _GQA, "ffn": _FFN},
               "dec_layers": {"self_attn": _GQA, "cross_attn": _GQA,
                              "ffn": _FFN}},
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
            if key in tree:
                out[key] = _cast_named(tree[key], sub, dt)
        return out
    for name in spec:
        if name in out:
            out[name] = tree_map(lambda t: t.to(dt), tree[name])
    return out


def cast_for_serving(cfg: ModelConfig, params):
    """A copy of ``params`` whose read-as-``cfg.dtype`` leaves are stored in
    ``cfg.dtype`` (:data:`_CAST`: the dense weights, the expert stacks,
    rwkv6's lerps, the mamba conv, the embedding table and an untied
    head's weight).  Every use of those leaves casts them to ``cfg.dtype``
    first, and a cast of a cast is the same cast, so the model's outputs
    are bitwise those of the f32 parameters; decode then reads half the
    bytes and skips one cast per use.  The leaves read in f32 (the MoE
    router, rwkv6's ``w0`` / ``u``, mamba's ``a_log`` / ``dt_bias`` /
    ``d_skip``, the norms, MLA's ``q_norm`` / ``kv_norm`` among them) stay
    f32.  The result shares the untouched leaves with ``params``.
    """
    dt = cfg.dtype
    out = _cast_named(params, _CAST[cfg.family], dt)
    out["embed"] = {"table": params["embed"]["table"].to(dt)}
    if "head" in params:
        out["head"] = {k: v.to(dt) for k, v in params["head"].items()}
    return out

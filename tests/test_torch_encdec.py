"""The port's encoder-decoder (``repro_torch.models.blocks``' encoder and
cross-attention decoder layers, ``models.model._build_encdec``) against
the JAX package on the seamless-m4t-medium smoke config (2 + 2 layers, d
128, 4 heads x 32, d_ff 256, ``gelu_plain``, layernorm, 64-wide frames,
vocab 512), with the parameters and inputs of ``tests/lm_parity.py``.

Tolerances (those of ``tests/test_torch_zamba2_model.py``, with their
reasons there): f32 normwise 1e-5 a layer and 1e-4 a bundle; bf16 2^-5 a
layer, and for the bundle the port's RMS error from the reference's f32
result within 0.5 to 1.25 times the reference's own bf16 RMS error; 2e-3
for decode against ``forward`` inside the port (the reference's own
decode-consistency tolerance).

The reference's serve entry point grows no cache of this family
(``src/repro/launch/serve.py:62``), so each of its decode steps writes at
``pos = s``, one past the ``s``-slot self cache, and
``jax.lax.dynamic_update_slice`` clamps the write onto the last prompt
slot.  The port grows the self cache (never the cross one, whose length is
the encoder's) and raises on a write past a cache.
``test_reference_serve_decodes_off_an_ungrown_cache_*`` pins both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (B, BUNDLE_TOL, ENCDEC, JAX_DT, TOL, TORCH_DT, batch,
                       cfgs, check_bundle, close, grow, jbundle, jparams,
                       params, positions, x)
from repro.models import blocks as JB
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import blocks as TB
from repro_torch.models import build_model
from repro_torch.tree import tree_map

torch.set_num_threads(2)

_j_enc = jax.jit(JB.encoder_layer_seq, static_argnums=1)
_j_xseq = jax.jit(JB.xattn_decoder_layer_seq, static_argnums=(1, 5, 6))
_j_xdec = jax.jit(JB.xattn_decoder_layer_decode, static_argnums=1)


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encoder_layer_matches_reference(dt):
    """``encoder_layer_seq``: bidirectional (``mode="full"``) attention
    over 10 frames' states, then the plain-gelu MLP."""
    jcfg, tcfg = cfgs(ENCDEC, dt)
    np_params, t_params = params(ENCDEC)
    jl = _layer0(np_params["enc_layers"])
    tl = tree_map(lambda a: a[0], t_params["enc_layers"])
    jx, tx = x((B, 10, 128), dt, seed=1)
    jpos, tpos = positions(10)
    with torch.inference_mode():
        close(TB.encoder_layer_seq(tl, tcfg, tx, tpos),
              _j_enc(jl, jcfg, jx, jpos), TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_xattn_decoder_layer_matches_reference(dt):
    """``xattn_decoder_layer_seq`` over 12 tokens and 10 encoder states,
    collecting ``{"self", "cross"}`` in ``cfg.dtype``; then
    ``xattn_decoder_layer_decode`` at position 12 from the reference's
    cache with the self part grown by one slot."""
    jcfg, tcfg = cfgs(ENCDEC, dt)
    np_params, t_params = params(ENCDEC)
    jl = _layer0(np_params["dec_layers"])
    tl = tree_map(lambda a: a[0], t_params["dec_layers"])
    jx, tx = x((B, 12, 128), dt, seed=2)
    je, te = x((B, 10, 128), dt, seed=3)
    jpos, tpos = positions(12)
    tol = TOL[dt]
    with torch.inference_mode():
        jy, jc = _j_xseq(jl, jcfg, jx, jpos, je, True, JAX_DT[dt])
        ty, tc = TB.xattn_decoder_layer_seq(tl, tcfg, tx, tpos, te,
                                            collect_cache=True,
                                            cache_dtype=TORCH_DT[dt])
        close(ty, jy, tol)
        assert sorted(tc) == ["cross", "self"]
        for part in jc:
            for k in jc[part]:
                assert tc[part][k].dtype == TORCH_DT[dt]
                close(tc[part][k], jc[part][k], tol)
        grown = grow(jc, 1, 12, axis=1)
        assert grown["self"]["k"].shape[1] == 13
        assert grown["cross"]["k"].shape[1] == 10
        jn, tn = x((B, 1, 128), dt, seed=4)
        jy, jc2 = _j_xdec(jl, jcfg, jn, grown, jnp.asarray(12, jnp.int32))
        tgrown = convert.to_torch(jax.tree_util.tree_map(np.asarray, grown),
                                  "cpu")
        ty, tc2 = TB.xattn_decoder_layer_decode(tl, tcfg, tn, tgrown, 12)
        assert tc2["self"] is tgrown["self"]
        close(ty, jy, tol)
        for part in jc2:
            for k in jc2[part]:
                close(tc2[part][k], jc2[part][k], tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bundle_matches_reference(dt):
    """``forward``, ``prefill`` (logits and the self and cross caches) and
    one ``decode_step`` over 16 tokens and 8 frames, against the
    reference's bundle (the module docstring's gates)."""
    ratios = check_bundle(ENCDEC, dt, 16)
    assert {"prefill.cross.k", "decode.self.v"} <= set(ratios)


def test_init_cache_is_the_reference_layout():
    """``init_cache(batch, cache_len, dtype, enc_len=)``: ``{"self",
    "cross"}`` stacked over the decoder's layers, the cross part
    ``enc_len`` long (``cache_len`` unless given)."""
    jcfg, tcfg = cfgs(ENCDEC, "bf16")
    tb, jb = build_model(tcfg, device="cpu"), jbuild_model(jcfg)
    for enc_len in (None, 6):
        want = jb.init_cache(B, 20, jnp.bfloat16, enc_len=enc_len)
        got = tb.init_cache(B, 20, torch.bfloat16, enc_len=enc_len)
        for part in want:
            for k in want[part]:
                assert tuple(got[part][k].shape) == want[part][k].shape
                assert got[part][k].dtype == torch.bfloat16
                assert not got[part][k].any()
    assert tuple(tb.init_cache(B, 20)["cross"]["k"].shape) == (2, B, 20, 4,
                                                               32)


def test_decode_matches_forward():
    """f32: prefill 12 tokens over 8 frames, decode 6 more one by one off
    the grown self cache, each step against ``forward`` at 2e-3."""
    _, tcfg = cfgs(ENCDEC, "f32")
    _, t_params = params(ENCDEC)
    tb = build_model(tcfg, device="cpu")
    _, tb_in = batch(tcfg, 18, seed=5)
    with torch.inference_mode():
        full = tb.forward(t_params, tb_in)
        _, cache = tb.prefill(t_params, dict(tb_in,
                                             tokens=tb_in["tokens"][:, :12]))
        cache = serve.grow_cache(cache, 6)
        assert tuple(cache["self"]["k"].shape)[2] == 18
        assert tuple(cache["cross"]["k"].shape)[2] == 8
        for i in range(12, 18):
            logits, cache = tb.decode_step(t_params, cache,
                                           tb_in["tokens"][:, i:i + 1], i)
            torch.testing.assert_close(logits, full[:, i], rtol=2e-3,
                                       atol=2e-3)


def test_reference_serve_decodes_off_an_ungrown_cache_the_port_grows_it():
    """A 12-token prompt over 8 frames, f32: the reference's serve entry point
    leaves the 12-slot self cache as it is, and its decode step at
    position 12 (clamped onto slot 11) lies more than 0.05 from its own
    ``forward``; grown by one slot, it lies within 2e-3.  The port's
    ``generate`` grows the self cache, its first decode step lies within
    2e-3 of its ``forward`` (which is the reference's), and a decode past
    an ungrown cache raises."""
    jcfg, tcfg = cfgs(ENCDEC, "f32")
    np_params, t_params = params(ENCDEC)
    jb_in, tb_in = batch(tcfg, 13, seed=6)
    _, fwd, pre, dec = jbundle(jcfg)
    jp = jparams(np_params)
    jfull = fwd(jp, jb_in)
    pre_in = dict(jb_in, tokens=jb_in["tokens"][:, :12])
    _, jc = pre(jp, pre_in)
    nxt, pos = jb_in["tokens"][:, 12:], jnp.asarray(12, jnp.int32)
    ungrown, _ = dec(jp, jc, nxt, pos)
    grown, _ = dec(jp, grow(jc, 1, 12), nxt, pos)
    want = np.asarray(jfull[:, -1])
    assert float(np.abs(np.asarray(ungrown) - want).max()) > 0.05
    assert float(np.abs(np.asarray(grown) - want).max()) <= 2e-3
    tb = build_model(tcfg, device="cpu")
    with torch.inference_mode():
        tfull = tb.forward(t_params, tb_in)
        close(tfull, jfull, BUNDLE_TOL["f32"])
        out = serve.generate(tb, t_params, dict(
            tb_in, tokens=tb_in["tokens"][:, :12]), 1)
        assert tuple(out["cache"]["self"]["k"].shape)[2] == 13
        _, cache = tb.prefill(t_params, dict(tb_in,
                                             tokens=tb_in["tokens"][:, :12]))
        logits, _ = tb.decode_step(t_params, serve.grow_cache(cache, 1),
                                   tb_in["tokens"][:, 12:], 12)
        torch.testing.assert_close(logits, tfull[:, -1], rtol=2e-3,
                                   atol=2e-3)
        with pytest.raises(IndexError, match="grow the cache"):
            tb.decode_step(t_params, cache, tb_in["tokens"][:, 12:], 12)


def test_convert_takes_each_stack_at_its_own_depth():
    """``lm_params_to_torch`` of an encoder-decoder with 3 encoder and 2
    decoder layers (``n_enc_layers``), refusing a wrong depth; the
    ``{"self", "cross"}`` cache round trip."""
    _, tcfg = cfgs(ENCDEC, "f32", n_enc_layers=3)
    np_params = convert.to_numpy(build_model(tcfg, device="cpu").init(
        torch.Generator().manual_seed(1)))
    assert np_params["enc_layers"]["attn"]["wq"]["w"].shape[0] == 3
    out = convert.lm_params_to_torch(np_params, 2, "cpu", n_enc_layers=3)
    assert out["adapter"]["w"].shape == (64, 128)
    with pytest.raises(ValueError, match="enc_layers leaves must be stacked"):
        convert.lm_params_to_torch(np_params, 2, "cpu")
    jcfg, _ = cfgs(ENCDEC, "bf16")
    cache = jax.tree_util.tree_map(np.asarray, jbuild_model(
        jcfg).init_cache(B, 12, jnp.bfloat16, enc_len=8))
    back = convert.cache_to_numpy(convert.cache_to_torch(cache, "cpu"))
    for part in cache:
        for k in cache[part]:
            np.testing.assert_array_equal(
                back[part][k].view(cache[part][k].dtype), cache[part][k])
    with pytest.raises(ValueError, match="keys"):
        convert.cache_to_torch({"self": cache["self"]}, "cpu")

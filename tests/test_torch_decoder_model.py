"""The port's decoder families (dense, MLA, MoE and the VLM's text stack:
``repro_torch.models.blocks`` and ``models.model._build_decoder``) against
the JAX package on the seven smoke configs of tinyllama-1.1b, chatglm3-6b
(qkv bias, half rotary), h2o-danube-3-4b (window 32), minicpm3-4b (MLA),
grok-1-314b (4 experts top-2, gelu), arctic-480b (4 experts and the dense
residual) and paligemma-3b (MQA, head dim 32, an 8-patch prefix).  The
parameters, drawn by the port from a seed, and the inputs, made with numpy
from a seed, are the same in both packages (``tests/lm_parity.py``).

Tolerances, each with its reason (normwise: max |port - reference| <= tol
* max |reference| over each output, logits and every cache leaf):

* 1e-5 in f32 for one layer and 1e-4 for a whole bundle, the gates of
  ``tests/test_torch_zamba2_model.py`` (PyTorch and XLA sum the same f32
  products in other orders);
* 2^-5 in bf16 for one layer; for a whole bundle in bf16 the port's RMS
  error from the reference's f32 result lies within 0.5 to 1.25 times the
  reference's own bf16 RMS error from it (the zamba2 tests' gate and its
  reasons: bf16 rounding grows through the layers until no fixed normwise
  gate tells a fault from it);
* 2e-3 for decode against ``forward`` inside the port, the reference's own
  decode-consistency tolerance (``tests/test_decode_consistency_all.py``,
  which runs every config in f32 with ``window=None`` and
  ``capacity_factor=4.0``: a 1-token decode and a prefill route the same
  token to the same experts only when no capacity drops it).

The reference decodes a windowed config from a full cache without its
window (``src/repro/nn/attention.py:216-218``), so past the window its
decode leaves its own ``forward``; the port masks by the window there and
stays on its ``forward``.  ``test_decode_past_the_window_*`` pins both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (B, BUNDLE_TOL, DECODERS, JAX_DT, TOL, TORCH_DT,
                       batch, cfgs, close, grow, jbundle,
                       jparams, params, positions, x)
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import blocks as JB
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve
from repro_torch.models import blocks as TB
from repro_torch.models import build_model
from repro_torch.tree import tree_map

torch.set_num_threads(2)

_j_seq = jax.jit(JB.decoder_layer_seq,
                 static_argnums=(1, 4, 5, 6, 7, 8))
_j_decode = jax.jit(JB.decoder_layer_decode, static_argnums=(1, 5))


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree)


def _mode(cfg):
    return ("prefix", cfg.n_prefix) if cfg.family == "vlm" else ("causal", 0)


def _close_tree(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == TORCH_DT["bf16" if want[k].dtype ==
                                        jnp.bfloat16 else "f32"], k
        close(got[k], want[k], tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_layer_matches_reference(arch, dt):
    """``decoder_layer_seq`` in the family's mask mode (the VLM's prefix
    mode over its 8 patches, the config's window), collecting its cache in
    ``cfg.dtype``, with the MoE loss; then ``decoder_layer_decode`` at the
    next position from the reference's cache grown by one slot, and the
    cache it writes.  The MoE loss is held at the layer's tolerance: in
    bf16 both routers see bf16 activations an ulp apart."""
    jcfg, tcfg = cfgs(arch, dt)
    np_params, t_params = params(arch)
    jl, tl = _layer0(np_params["layers"]), tree_map(lambda a: a[0],
                                                     t_params["layers"])
    mode, prefix = _mode(tcfg)
    s = 20
    jx, tx = x((B, s, tcfg.d_model), dt, seed=3)
    jpos, tpos = positions(s)
    tol = TOL[dt]
    with torch.inference_mode():
        jy, jc, jaux = _j_seq(jl, jcfg, jx, jpos, mode, prefix, True,
                              JAX_DT[dt], "cfg")
        ty, tc, aux = TB.decoder_layer_seq(tl, tcfg, tx, tpos, mode, prefix,
                                           collect_cache=True,
                                           cache_dtype=TORCH_DT[dt])
        close(ty, jy, tol)
        _close_tree(tc, jc, tol)
        assert aux.dtype == torch.float32
        np.testing.assert_allclose(float(aux), float(jaux), rtol=tol)
        assert (float(aux) == 0.0) == (tcfg.n_experts == 0)
        grown = grow(jc, 1, s, axis=1)
        jnext, tnext = x((B, 1, tcfg.d_model), dt, seed=4)
        jy, jc2 = _j_decode(jl, jcfg, jnext, grown,
                            jnp.asarray(s, jnp.int32), "cfg")
        tgrown = convert.to_torch(jax.tree_util.tree_map(np.asarray, grown),
                                  "cpu")
        ty, tc2 = TB.decoder_layer_decode(tl, tcfg, tnext, tgrown, s)
        assert tc2 is tgrown
        close(ty, jy, tol)
        _close_tree(tc2, jc2, tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_windowed_layer_and_ring_cache_match_reference(dt):
    """The danube layer over 40 positions (its 32-window masks the first
    8 keys of the last rows), and 12 decode steps through a ring cache of
    the window's size (``init_decoder_cache`` with ``cache_len`` 44 > 32;
    the ring wraps), outputs and the ring's positions each step."""
    arch = "h2o-danube-3-4b"
    jcfg, tcfg = cfgs(arch, dt)
    np_params, t_params = params(arch)
    jl, tl = _layer0(np_params["layers"]), tree_map(lambda a: a[0],
                                                     t_params["layers"])
    jx, tx = x((B, 40, tcfg.d_model), dt, seed=5)
    jpos, tpos = positions(40)
    with torch.inference_mode():
        jy, _, _ = _j_seq(jl, jcfg, jx, jpos, "causal", 0, False,
                          JAX_DT[dt], "cfg")
        ty, tc, _ = TB.decoder_layer_seq(tl, tcfg, tx, tpos)
        assert tc is None
        close(ty, jy, TOL[dt])
        jc = JB.init_decoder_cache(jcfg, B, 44, JAX_DT[dt])
        tc = TB.init_decoder_cache(tcfg, B, 44, TORCH_DT[dt], device="cpu")
        assert sorted(tc) == sorted(jc) == ["k", "positions", "v"]
        assert tuple(tc["k"].shape)[1] == 32
        for pos in range(28, 40):
            jy, jc = _j_decode(jl, jcfg, jx[:, pos - 28:pos - 27], jc,
                               jnp.asarray(pos, jnp.int32), "cfg")
            ty, tc = TB.decoder_layer_decode(tl, tcfg, tx[:, pos - 28:
                                                          pos - 27], tc, pos)
            close(ty, jy, TOL[dt])
            np.testing.assert_array_equal(tc["positions"].numpy(),
                                          np.asarray(jc["positions"]))


@pytest.mark.parametrize("arch", DECODERS)
def test_init_cache_is_the_reference_layout(arch):
    """``init_cache``: the same keys, shapes, dtypes and zeros (a window
    shorter than the cache gives the ring, with positions -1), and a
    ``window=None`` override the full cache."""
    jcfg, tcfg = cfgs(arch, "bf16")
    tb = build_model(tcfg, device="cpu")
    jb = jbuild_model(jcfg)
    for kw in (dict(cache_len=20), dict(cache_len=40),
               dict(cache_len=40, window=None)):
        want = jax.tree_util.tree_map(np.asarray, jb.init_cache(
            B, dtype=jnp.bfloat16, **kw))
        got = convert.to_numpy(tb.init_cache(B, dtype=torch.bfloat16, **kw))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, (kw, k)
            np.testing.assert_array_equal(got[k], want[k].view(got[k].dtype))
    assert tb.init_cache(B, 8)["ckv" if tcfg.mla else "k"].device == \
        torch.device("cpu")


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward(arch):
    """f32, ``window=None`` and ``capacity_factor=4.0`` (the reference
    oracle's settings): prefill 16 positions, then decode 8 tokens one by
    one, each step's logits against ``forward`` over all 24 at 2e-3."""
    _, tcfg = cfgs(arch, "f32", window=None, capacity_factor=4.0)
    _, t_params = params(arch)
    tb = build_model(tcfg, device="cpu")
    _, tb_in = batch(tcfg, 24, seed=9)
    n_pre = tcfg.n_prefix if tcfg.family == "vlm" else 0
    with torch.inference_mode():
        full = tb.forward(t_params, tb_in)
        pre = dict(tb_in, tokens=tb_in["tokens"][:, :16 - n_pre])
        _, cache = tb.prefill(t_params, pre)
        cache = serve.grow_cache(cache, 8)
        for i in range(16, 24):
            tok = tb_in["tokens"][:, i - n_pre:i - n_pre + 1]
            logits, cache = tb.decode_step(t_params, cache, tok, i)
            torch.testing.assert_close(logits, full[:, i], rtol=2e-3,
                                       atol=2e-3)


def _danube_decode_gap(prompt):
    """The danube smoke config (window 32) in f32: prefill ``prompt``
    tokens, decode the next one.  Returns (reference decode - reference
    forward, port decode - port forward, port decode - reference decode),
    each a max abs over the logits."""
    arch = "h2o-danube-3-4b"
    jcfg, tcfg = cfgs(arch, "f32")
    assert tcfg.window == 32
    np_params, t_params = params(arch)
    jb_in, tb_in = batch(tcfg, prompt + 1, seed=11)
    _, fwd, pre, dec = jbundle(jcfg)
    jp = jparams(np_params)
    jfull = fwd(jp, jb_in)
    _, jc = pre(jp, {"tokens": jb_in["tokens"][:, :prompt]})
    jd, _ = dec(jp, grow(jc, 1, prompt), jb_in["tokens"][:, prompt:],
                jnp.asarray(prompt, jnp.int32))
    tb = build_model(tcfg, device="cpu")
    with torch.inference_mode():
        tfull = tb.forward(t_params, tb_in)
        _, tc = tb.prefill(t_params, {"tokens": tb_in["tokens"][:, :prompt]})
        td, _ = tb.decode_step(t_params, serve.grow_cache(tc, 1),
                               tb_in["tokens"][:, prompt:], prompt)
    jd, jf = np.asarray(jd), np.asarray(jfull[:, -1])
    close(tfull, jfull, BUNDLE_TOL["f32"])
    return (float(np.abs(jd - jf).max()),
            float((td - tfull[:, -1]).abs().max()),
            float(np.abs(td.numpy() - jd).max()))


def test_decode_past_the_window_matches_forward_where_the_reference_does_not():
    """A 40-token prompt past the 32 window: the reference's decode step
    attends to all 40 cached keys and lies far from its own ``forward``
    (> 0.05); the port's masks by the window and lies within 2e-3 of its
    ``forward``, which is the reference's (1e-4)."""
    ref_gap, port_gap, _ = _danube_decode_gap(40)
    assert ref_gap > 0.05
    assert port_gap <= 2e-3


def test_decode_within_the_window_is_the_reference():
    """A 20-token prompt (prompt + 1 <= window): the two masks agree, and
    the port's decode step is the reference's (1e-4 of its largest logit;
    both within 2e-3 of ``forward``)."""
    ref_gap, port_gap, diff = _danube_decode_gap(20)
    assert ref_gap <= 2e-3 and port_gap <= 2e-3
    assert diff <= 1e-3


def test_window_options_override_the_config():
    """``prefill(window=None)`` attends past the 32 window, as the
    reference's; ``decode_step(window=None)`` then equals the reference's
    decode (its full-cache mask has no window)."""
    arch = "h2o-danube-3-4b"
    jcfg, tcfg = cfgs(arch, "f32")
    np_params, t_params = params(arch)
    jb_in, tb_in = batch(tcfg, 40, seed=12)
    jb, _, _, _ = jbundle(jcfg)
    jp = jparams(np_params)
    jl, jc = jax.jit(jb.prefill, static_argnames="window")(
        jp, jb_in, window=None)
    tb = build_model(tcfg, device="cpu")
    with torch.inference_mode():
        tl, tc = tb.prefill(t_params, tb_in, window=None)
        close(tl, jl, BUNDLE_TOL["f32"])
        tl_cfg, _ = tb.prefill(t_params, tb_in)
        assert float((tl - tl_cfg).abs().max()) > 1e-3
        nxt = jnp.asarray(np.full((B, 1), 3), jnp.int32)
        jd, _ = jax.jit(jb.decode_step, static_argnames="window")(
            jp, grow(jc, 1, 40), nxt, jnp.asarray(40, jnp.int32),
            window=None)
        td, _ = tb.decode_step(t_params, serve.grow_cache(tc, 1),
                               torch.full((B, 1), 3), 40, window=None)
        close(td, jd, BUNDLE_TOL["f32"])


@pytest.mark.parametrize("arch", DECODERS + ["seamless-m4t-medium"])
def test_configs_are_the_reference_values(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke(arch), jget_smoke(arch))):
        fields = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(port)] == fields
        for name in fields:
            if name != "dtype":
                assert getattr(port, name) == getattr(ref, name), name
        assert port.dtype == torch.bfloat16
        assert port.attn_cfg().rotary_dim == ref.attn_cfg().rotary_dim
        assert dataclasses.asdict(port.attn_cfg()) == dataclasses.asdict(
            ref.attn_cfg())
        assert dataclasses.asdict(port.mla_cfg()) == dataclasses.asdict(
            ref.mla_cfg())
        assert dataclasses.asdict(port.moe_cfg()) == dataclasses.asdict(
            ref.moe_cfg())


def test_convert_checks_trees_and_round_trips_the_caches():
    """``lm_params_to_torch`` on the MoE tree (expert stacks over the
    layers) and the VLM's (the projector beside), refusing a wrong depth;
    ``cache_to_torch`` / ``cache_to_numpy`` on the full, windowed and MLA
    caches, refusing unknown keys."""
    np_params, _ = params("arctic-480b")
    assert np_params["layers"]["ffn"]["w_in"].shape == (2, 4, 128, 128)
    out = convert.lm_params_to_torch(np_params, 2, "cpu")
    assert out["layers"]["ffn"]["dense_mlp"]["w_gate"]["w"].shape == (
        2, 128, 128)
    with pytest.raises(ValueError, match="stacked"):
        convert.lm_params_to_torch(np_params, 3, "cpu")
    np_vlm, _ = params("paligemma-3b")
    assert convert.lm_params_to_torch(np_vlm, 2, "cpu")["projector"][
        "w"].shape == (64, 128)
    for arch, kw in (("tinyllama-1.1b", {}), ("h2o-danube-3-4b", {}),
                     ("minicpm3-4b", {})):
        jcfg, _ = cfgs(arch, "bf16")
        cache = jax.tree_util.tree_map(np.asarray, jbuild_model(
            jcfg).init_cache(B, 40, jnp.bfloat16))
        back = convert.cache_to_numpy(convert.cache_to_torch(cache, "cpu"))
        assert sorted(back) == sorted(cache)
        for k in cache:
            np.testing.assert_array_equal(
                back[k].view(cache[k].dtype), cache[k])
    with pytest.raises(ValueError, match="keys"):
        convert.cache_to_torch({"ckv": np.zeros(2)}, "cpu")

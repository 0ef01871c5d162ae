"""The port's zamba2 (hybrid) serving path against the JAX package, on the
zamba2-7b SMOKE config (5 Mamba2 layers of d 128, 8 heads x 32, state 16;
the shared attention + MLP block after every 2 layers: 2 groups and 1
trailing layer; 4 attention heads x 32, d_ff 256, vocab 512): one set of
f32 parameters drawn from a seed, handed to the reference as numpy and
carried into the port by ``repro_torch.convert``, and inputs made with
numpy from a seed.  Sequences of 64 take the chunked SSD
scan (the reference's own decode-consistency tests use 32, which only
reaches the recurrence); 63 takes the recurrence.  The serve entry point and
``cast_for_serving`` are held in ``tests/test_torch_zamba2_serve.py``.

Tolerances, each with its reason (normwise: max |port - reference| <=
tol * max |reference| over each output, logits and every cache leaf):

* 1e-5 in f32 (``dtype=float32``) for one block or layer: the same f32
  algorithm; PyTorch's and XLA's matmuls, reductions and scans sum in
  different orders, and a reordered sum errs relative to the size of its
  terms, not of its result (hence normwise); the largest ratio measured
  was 1.5e-6;
* 1e-4 in f32 for the whole bundle, the rwkv6 bundle's f32 tolerance
  (``tests/test_torch_rwkv6_model.py``): the same orders of summation
  through five layers; the largest ratio measured was 9.2e-6 (and 1.2e-5
  on parameters from the reference's own ``init``, 63 tokens through the
  recurrence), too near 1e-5 to gate on;
* 2^-5 in bf16 for one block or layer (4 bf16 ulps of the largest
  element, the rwkv6 model tests' bf16 gate): XLA and PyTorch round bf16
  at different places (the sum orders of bf16 products; XLA's
  ``jax.nn.silu`` rounds after each of its four ops), so single elements
  differ by an ulp; the largest ratio measured was 0.0092;
* in bf16 for the whole bundle (five layers and two attention
  applications), those ulps grow through the layers until the port's
  bf16 outputs lie as far from the reference's bf16 ones (0.06 normwise
  on the logits) as both lie from the f32 result, so no fixed normwise
  gate tells a fault from rounding.  The bundle is held instead to the
  reference's own bf16 error, measured in the same test: for each output
  and cache leaf, the port's bf16 RMS error from the reference's f32
  result lies within 0.5 to 1.25 times the reference's bf16 RMS error
  from it.  Above 1.25 the port adds error of its own (a cast in the
  wrong place, a wrong leaf); below 0.5 it rounds far less than the
  model's dtype says (the model run in f32).  Over eight prompts (seeds
  7 to 37, 63 and 64 tokens) the ratio ranged from 0.73 to 1.15; the
  max-abs ratio is too noisy on tensors this small (up to 1.6) to gate
  on.  What neither this gate nor the 2^-5 block gates can see is one
  cast moved within bf16's own rounding: xh or a_log rounded to bf16,
  attention's PV product or every dense product in f32 moved the ratio
  by at most 0.2 and the block errors by at most 0.006.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import blocks as JB
from repro.models import build_model as jbuild_model
from repro.nn import ssm as JS
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve
from repro_torch.models import blocks as TB
from repro_torch.models import build_model
from repro_torch.nn import ssm as TS
from repro_torch.tree import tree_map

torch.set_num_threads(2)

_j_block = jax.jit(JS.mamba2_block, static_argnums=1)
_j_decode = jax.jit(JS.mamba2_decode, static_argnums=1)
_j_layer_seq = jax.jit(JB.mamba_layer_seq, static_argnums=1)
_j_layer_decode = jax.jit(JB.mamba_layer_decode, static_argnums=1)
_j_dec_seq = jax.jit(JB.decoder_layer_seq, static_argnums=(1, 4, 5, 6, 7))
_j_dec_decode = jax.jit(JB.decoder_layer_decode, static_argnums=1)

ARCH = "zamba2-7b"
B = 2
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -5}
BUNDLE_TOL = {"f32": 1e-4, "bf16": (0.5, 1.25)}


def _cfgs(dt):
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype=JAX_DT[dt],
                               remat=False)
    tcfg = dataclasses.replace(get_smoke(ARCH), dtype=TORCH_DT[dt],
                               remat=False)
    return jcfg, tcfg


_PARAMS = {}


def _params():
    """f32 parameters as numpy (for the reference) and carried into the
    port by ``convert`` (the same for both dtypes: every use casts).  They
    are drawn by the port's ``init`` from seed 0, with the reference's
    shapes and scales: the reference's own ``init`` runs op by op and takes
    seconds."""
    if not _PARAMS:
        _, tcfg = _cfgs("f32")
        drawn = build_model(tcfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        np_params = convert.to_numpy(drawn)
        _PARAMS["p"] = (np_params, convert.lm_params_to_torch(
            np_params, tcfg.n_layers, "cpu"))
    return _PARAMS["p"]


def _np(t):
    """A port tensor as f32 numpy (bf16 through its bits)."""
    a = convert.to_numpy(t)
    if t.dtype == torch.bfloat16:
        a = np.asarray(jnp.asarray(a.view(jnp.bfloat16), jnp.float32))
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    got = _np(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"


def _close_tree(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            _close_tree(got[k], want[k], tol)
        else:
            assert got[k].dtype == {jnp.float32: torch.float32,
                                    jnp.bfloat16: torch.bfloat16}[
                                        want[k].dtype.type], k
            _close(got[k], want[k], tol)


def _x(shape, dt, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, JAX_DT[dt])
    return jx, convert.to_torch(np.asarray(jx), "cpu")


def _mamba_state(tcfg, seed):
    """A nonzero mamba state for one layer, numpy f32."""
    rng = np.random.default_rng(seed)
    c = tcfg.mamba_cfg()
    conv_ch = c.d_inner + 2 * c.d_state
    return {"h": rng.standard_normal((B, c.n_heads, c.head_dim, c.d_state)
                                     ).astype(np.float32),
            "conv": rng.standard_normal((B, c.d_conv - 1, conv_ch)
                                        ).astype(np.float32)}


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("seq", [64, 63], ids=["chunked", "recurrent"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba_block_layer_and_decode_match_reference(dt, seq):
    """``mamba2_block`` from a zero and a carried state,
    ``mamba_layer_seq``, ``mamba_layer_decode`` and ``mamba2_decode``
    against the JAX functions; S = 64 takes the chunked scan, 63 the
    recurrence."""
    jcfg, tcfg = _cfgs(dt)
    np_params, t_params = _params()
    jl, tl = _layer0(np_params["mamba"]), tree_map(lambda a: a[0],
                                                   t_params["mamba"])
    jx, tx = _x((B, seq, tcfg.d_model), dt, seed=seq)
    tol = TOL[dt]
    with torch.inference_mode():
        for st in (None, _mamba_state(tcfg, seed=seq + 1)):
            jst = None if st is None else jax.tree_util.tree_map(
                jnp.asarray, st)
            tst = None if st is None else convert.to_torch(st, "cpu")
            jy, jnew = _j_block(jl["blk"], jcfg.mamba_cfg(), jx, jst)
            ty, tnew = TS.mamba2_block(tl["blk"], tcfg.mamba_cfg(), tx, tst)
            assert ty.dtype == TORCH_DT[dt]
            _close(ty, jy, tol)
            _close_tree(tnew, jnew, tol)
        jy, jnew = _j_layer_seq(jl, jcfg, jx, jst)
        ty, tnew = TB.mamba_layer_seq(tl, tcfg, tx, tst)
        _close(ty, jy, tol)
        _close_tree(tnew, jnew, tol)
        jy, jnew = _j_layer_decode(jl, jcfg, jx[:, :1], jst)
        ty, tnew = TB.mamba_layer_decode(tl, tcfg, tx[:, :1], tst)
        _close(ty, jy, tol)
        _close_tree(tnew, jnew, tol)
        jy, _ = _j_decode(jl["blk"], jcfg.mamba_cfg(), jx[:, :1], jst)
        ty, _ = TS.mamba2_decode(tl["blk"], tcfg.mamba_cfg(), tx[:, :1], tst)
        _close(ty, jy, tol)


def _positions(s, offset=0):
    p = np.broadcast_to(np.arange(s, dtype=np.int32) + offset, (B, s))
    return jnp.asarray(p), torch.from_numpy(np.ascontiguousarray(p))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decoder_layer_matches_reference(dt):
    """The shared block: ``decoder_layer_seq`` collecting its cache (in
    ``cfg.dtype``, as the hybrid prefill does), then
    ``decoder_layer_decode`` at the next position from the reference's
    cache grown by one slot."""
    jcfg, tcfg = _cfgs(dt)
    np_params, t_params = _params()
    jsh, tsh = np_params["shared_attn"], t_params["shared_attn"]
    jx, tx = _x((B, 24, tcfg.d_model), dt, seed=3)
    jpos, tpos = _positions(24)
    tol = TOL[dt]
    with torch.inference_mode():
        jy, jc, _ = _j_dec_seq(jsh, jcfg, jx, jpos, "causal", 0, True,
                               JAX_DT[dt])
        ty, tc, aux = TB.decoder_layer_seq(tsh, tcfg, tx, tpos,
                                           collect_cache=True,
                                           cache_dtype=TORCH_DT[dt])
        assert float(aux) == 0.0
        _close(ty, jy, tol)
        _close_tree(tc, jc, tol)
        grown = {k: jnp.pad(v, ((0, 0), (0, 1), (0, 0), (0, 0)))
                 for k, v in jc.items()}
        jnext, tnext = _x((B, 1, tcfg.d_model), dt, seed=4)
        jy, jc2 = _j_dec_decode(jsh, jcfg, jnext, grown,
                                jnp.asarray(24, jnp.int32))
        ty, tc2 = TB.decoder_layer_decode(
            tsh, tcfg, tnext, convert.to_torch(
                {k: np.asarray(v) for k, v in grown.items()}, "cpu"), 24)
        _close(ty, jy, tol)
        _close_tree(tc2, jc2, tol)


def _tokens(seq, vocab, seed=7):
    t = np.random.default_rng(seed).integers(0, vocab, (B, seq))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def _grow(cache, n):
    """The reference's attention caches grown by n slots, by key."""
    attn = {k: jnp.pad(v, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
            for k, v in cache["attn"].items()}
    return dict(cache, attn=attn)


def _port_cache(cache):
    return convert.cache_to_torch(
        jax.tree_util.tree_map(np.asarray, cache), "cpu")


def _flat(logits, caches):
    """{name: array} of a bundle's outputs: the logits of forward, prefill
    and decode, and every leaf of the prefill and the decode caches."""
    out = dict(logits)
    for tag, cache in caches.items():
        out.update({f"{tag}.{part}.{k}": v for part in cache
                    for k, v in cache[part].items()})
    return out


def _reference_bundle(dt, jparams, jtok, jnext, seq):
    """The reference bundle's outputs in ``dt``; decode from its own
    prefill cache grown by one slot."""
    jcfg, _ = _cfgs(dt)
    jb = jbuild_model(jcfg)
    jf = jax.jit(jb.forward)(jparams, {"tokens": jtok})
    jl, jc = jax.jit(jb.prefill)(jparams, {"tokens": jtok})
    jd, jc2 = jax.jit(jb.decode_step)(jparams, _grow(jc, 1), jnext,
                                      jnp.asarray(seq, jnp.int32))
    return _flat({"forward": jf, "prefill": jl, "decode": jd},
                 {"prefill": jc, "decode": jc2})


def _rms_rel(got, want):
    """||got - want|| / ||want|| over all elements, in f32."""
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("seq", [64, 63], ids=["chunked", "recurrent"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bundle_matches_reference(dt, seq):
    """``forward``, ``prefill`` (logits and every cache leaf),
    ``init_cache`` (structure, shapes, dtypes) and ``decode_step``
    against the reference bundle's.  f32: normwise at 1e-4, decode from
    the reference's cache.  bf16: the whole chain (decode from the port's
    own prefill cache) against the reference's f32 outputs, its error
    bounded by the reference's own bf16 error (module docstring)."""
    jcfg, tcfg = _cfgs(dt)
    np_params, t_params = _params()
    tb = build_model(tcfg, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jtok, ttok = _tokens(seq, tcfg.vocab)
    jnext, tnext = _tokens(1, tcfg.vocab, seed=8)
    ref = _reference_bundle(dt, jparams, jtok, jnext, seq)
    with torch.inference_mode():
        tf = tb.forward(t_params, {"tokens": ttok})
        tlog, tc = tb.prefill(t_params, {"tokens": ttok})
        assert tuple(tlog.shape) == (B, 1, tcfg.vocab)
        empty_j = jbuild_model(jcfg).init_cache(B, seq + 1, JAX_DT[dt])
        empty_t = tb.init_cache(B, seq + 1, TORCH_DT[dt], device="cpu")
        _close_tree(empty_t, empty_j, 0.0)
        if dt == "f32":
            jc = {p: {k: ref[f"prefill.{p}.{k}"] for k in tc[p]}
                  for p in tc}
            start = _port_cache(_grow(jc, 1))
        else:
            start = serve.grow_cache(
                tree_map(lambda t: t.clone(), tc), 1)
        td, tc2 = tb.decode_step(t_params, start, tnext, seq)
        assert tuple(td.shape) == (B, tcfg.vocab)
    port = _flat({"forward": tf, "prefill": tlog, "decode": td},
                 {"prefill": tc, "decode": tc2})
    assert sorted(port) == sorted(ref)
    for k in port:
        assert port[k].dtype == {jnp.float32: torch.float32,
                                 jnp.bfloat16: torch.bfloat16}[
                                     ref[k].dtype.type], k
    if dt == "f32":
        for k in port:
            _close(port[k], ref[k], BUNDLE_TOL[dt])
        return
    ref32 = _reference_bundle("f32", jparams, jtok, jnext, seq)
    lo, hi = BUNDLE_TOL[dt]
    for k in port:
        own, ours = _rms_rel(ref[k], ref32[k]), _rms_rel(port[k], ref32[k])
        assert lo * own <= ours <= hi * own, \
            f"{k}: port bf16 {ours} vs reference bf16 {own} from f32"


def test_convert_checks_trees_and_round_trips_the_cache():
    np_params, _ = _params()
    with pytest.raises(ValueError, match="stacked"):
        convert.lm_params_to_torch(np_params, 3, "cpu")
    with pytest.raises(ValueError, match="LM parameter"):
        convert.lm_params_to_torch({"mamba": np_params["mamba"]}, 5, "cpu")
    jcfg, _ = _cfgs("bf16")
    cache = jax.tree_util.tree_map(
        np.asarray, jbuild_model(jcfg).init_cache(B, 12, jnp.bfloat16))
    back = convert.cache_to_numpy(convert.cache_to_torch(cache, "cpu"))
    for part in cache:
        for k in cache[part]:
            np.testing.assert_array_equal(back[part][k].view(
                cache[part][k].dtype), cache[part][k])
    with pytest.raises(ValueError, match="keys"):
        convert.cache_to_torch({"mamba": cache["mamba"]}, "cpu")


def test_configs_are_the_reference_values():
    for port, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (get_smoke(ARCH), jget_smoke(ARCH))):
        fields = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(port)] == fields
        for name in fields:
            if name != "dtype":
                assert getattr(port, name) == getattr(ref, name), name
        assert port.dtype == torch.bfloat16
        assert port.mamba_cfg().n_heads == ref.mamba_cfg().n_heads
        assert port.attn_cfg().rotary_dim == ref.attn_cfg().rotary_dim
    full = get_config(ARCH)
    assert (full.mamba_cfg().n_heads, full.hd, full.n_layers // 6) == (
        112, 112, 13)


def test_moe_and_mla_decoder_layers_raise_naming_the_roadmap():
    cfg = get_smoke(ARCH)
    gen = torch.Generator().manual_seed(0)
    for over in (dict(mla=True), dict(n_experts=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TB.init_decoder_layer(gen, dataclasses.replace(cfg, **over))
    bundle = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bundle.loss({}, {})

"""The port's multi-head latent attention, cross-attention and
Mixture-of-Experts (``repro_torch.nn.attention``, ``repro_torch.nn.moe``)
against the JAX package (``repro.nn.attention``, ``repro.nn.moe``) on the
same parameters and inputs, made with numpy from a seed.  MLA takes the
minicpm3 smoke config's widths (d 128, 4 heads, q rank 48, kv rank 32,
nope 16, rope 8, v 16), MoE the grok and arctic smoke configs' (d 128, 4
experts top-2, d_ff 256 gelu / 128 silu with the dense residual), the
cross-attention 4 heads over 2 kv heads of 8.

Tolerances (normwise: max |port - reference| <= tol * max |reference|),
those of ``tests/test_torch_zamba2_model.py`` for one block:

* 1e-5 in f32: the same f32 algorithm, einsums and softmax sums in other
  orders;
* 2^-5 in bf16 (4 bf16 ulps of the largest element): XLA and PyTorch
  round bf16 intermediates at different places.

Routing is exact: the experts chosen, the capacity slots and the dropped
choices are compared as integers, and on exact ties both packages pick
the lower expert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro.nn import moe as JM
from repro_torch import convert
from repro_torch.nn import attention as TA
from repro_torch.nn import moe as TM

torch.set_num_threads(2)

B = 2
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -5}
MLA = dict(d_model=128, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
           qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
CROSS = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
MOE = {"grok": dict(d_model=128, d_ff=256, n_experts=4, top_k=2,
                    activation="gelu"),
       "arctic": dict(d_model=128, d_ff=128, n_experts=4, top_k=2,
                      activation="silu", dense_residual=True)}

_j_mla = jax.jit(JA.mla_attention, static_argnums=(1, 4))
_j_mla_qkv = jax.jit(JA._mla_qkv, static_argnums=1)
_j_mla_decode = jax.jit(JA.mla_decode, static_argnums=1)
_j_cross = jax.jit(JA.cross_attention, static_argnums=(1, 4))
_j_cross_cache = jax.jit(JA.make_cross_cache, static_argnums=(1, 3))
_j_cross_decode = jax.jit(JA.cross_attention_decode, static_argnums=1)
_j_moe = jax.jit(JM.moe, static_argnums=1)


def _np(t):
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


def _x(shape, dt, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, JAX_DT[dt])
    return jx, convert.to_torch(np.asarray(jx), "cpu")


def _pos(s, offset=0):
    p = np.broadcast_to(np.arange(s, dtype=np.int32) + offset, (B, s))
    return jnp.asarray(p), torch.from_numpy(np.ascontiguousarray(p))


def _params(init, cfg, seed=0):
    """f32 parameters drawn by the port's ``init``, as numpy for the
    reference and as tensors for the port."""
    drawn = init(torch.Generator().manual_seed(seed), cfg)
    np_p = convert.to_numpy(drawn)
    return jax.tree_util.tree_map(jnp.asarray, np_p), convert.to_torch(
        np_p, "cpu")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_mla_config_is_the_reference_config():
    fields = [f.name for f in dataclasses.fields(JA.MLAConfig)]
    assert [f.name for f in dataclasses.fields(TA.MLAConfig)] == fields
    assert TA.MLAConfig(128, 4) == TA.MLAConfig(
        **dataclasses.asdict(JA.MLAConfig(128, 4)))


@pytest.mark.parametrize("q_chunk", [None, 4], ids=["whole", "q_chunk4"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_attention_and_latent_match_reference(dt, q_chunk):
    """``mla_attention`` (whole and in query blocks) and the latent it
    attends over (``mla_attention_latent``: ckv and the rotated krope)
    against ``mla_attention`` and ``_mla_qkv``."""
    jp, tp = _params(TA.init_mla, TA.MLAConfig(**MLA))
    jcfg, tcfg = JA.MLAConfig(**MLA), TA.MLAConfig(**MLA)
    jx, tx = _x((B, 16, MLA["d_model"]), dt, seed=1)
    jpos, tpos = _pos(16)
    with torch.inference_mode():
        want = _j_mla(jp, jcfg, jx, jpos, q_chunk)
        got, ckv, krope = TA.mla_attention_latent(tp, tcfg, tx, tpos,
                                                  q_chunk=q_chunk)
        assert got.dtype == TORCH_DT[dt]
        _close(got, want, TOL[dt])
        _close(TA.mla_attention(tp, tcfg, tx, tpos, q_chunk), want, TOL[dt])
        _, _, jckv, jkrope = _j_mla_qkv(jp, jcfg, jx, jpos)
        _close(ckv, jckv, TOL[dt])
        _close(krope, jkrope, TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_decode_matches_reference(dt):
    """Seven tokens decoded one at a time from an empty 8-slot latent
    cache: each output, and the whole cache after every step (written in
    place in the port)."""
    jp, tp = _params(TA.init_mla, TA.MLAConfig(**MLA), seed=2)
    jcfg, tcfg = JA.MLAConfig(**MLA), TA.MLAConfig(**MLA)
    jc = JA.init_mla_cache(B, 8, jcfg, JAX_DT[dt])
    tc = TA.init_mla_cache(B, 8, tcfg, TORCH_DT[dt], device="cpu")
    assert sorted(tc) == sorted(jc)
    jx, tx = _x((B, 7, MLA["d_model"]), dt, seed=3)
    with torch.inference_mode():
        for pos in range(7):
            want, jc = _j_mla_decode(jp, jcfg, jx[:, pos:pos + 1], jc,
                                     jnp.asarray(pos, jnp.int32))
            got, out = TA.mla_decode(tp, tcfg, tx[:, pos:pos + 1], tc, pos)
            assert out["ckv"] is tc["ckv"] and out["krope"] is tc["krope"]
            _close(got, want, TOL[dt])
            for k in jc:
                assert tc[k].dtype == TORCH_DT[dt]
                _close(tc[k], jc[k], TOL[dt])
        with pytest.raises(IndexError, match="grow the cache"):
            TA.mla_decode(tp, tcfg, tx[:, :1], tc, 8)


def test_mla_decode_equals_mla_attention():
    """Inside the port: decode over the latent cache equals causal MLA
    over the whole sequence at each position (f32, 1e-5)."""
    _, tp = _params(TA.init_mla, TA.MLAConfig(**MLA), seed=4)
    tcfg = TA.MLAConfig(**MLA)
    _, tx = _x((B, 12, MLA["d_model"]), "f32", seed=5)
    _, tpos = _pos(12)
    with torch.inference_mode():
        full = TA.mla_attention(tp, tcfg, tx, tpos)
        cache = TA.init_mla_cache(B, 12, tcfg, torch.float32, device="cpu")
        for pos in range(12):
            got, cache = TA.mla_decode(tp, tcfg, tx[:, pos:pos + 1], cache,
                                       pos)
            _close(got[:, 0], full[:, pos].numpy(), 1e-5)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_chunk", [None, 4], ids=["whole", "q_chunk4"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cross_attention_matches_reference(dt, q_chunk):
    """``cross_attention`` over 10 encoder states, the cross cache
    (``make_cross_cache`` in the activations' dtype) and
    ``cross_attention_decode`` over it."""
    jcfg, tcfg = JA.AttnConfig(**CROSS), TA.AttnConfig(**CROSS)
    jp, tp = _params(TA.init_cross_attention, tcfg, seed=6)
    jx, tx = _x((B, 16, CROSS["d_model"]), dt, seed=7)
    je, te = _x((B, 10, CROSS["d_model"]), dt, seed=8)
    with torch.inference_mode():
        _close(TA.cross_attention(tp, tcfg, tx, te, q_chunk=q_chunk),
               _j_cross(jp, jcfg, jx, je, q_chunk), TOL[dt])
        jc = _j_cross_cache(jp, jcfg, je, JAX_DT[dt])
        tc = TA.make_cross_cache(tp, tcfg, te, TORCH_DT[dt])
        assert sorted(tc) == sorted(jc) == ["k", "v"]
        for k in jc:
            _close(tc[k], jc[k], TOL[dt])
        _close(TA.cross_attention_decode(tp, tcfg, tx[:, :1], tc),
               _j_cross_decode(jp, jcfg, jx[:, :1], jc), TOL[dt])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_cfgs(kind, **over):
    kw = dict(MOE[kind], **over)
    return JM.MoeConfig(**kw), TM.MoeConfig(**kw)


def _routing(probs, k, e, cap):
    """The reference's slot arithmetic in numpy: (chosen experts, kept)."""
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    flat = idx.reshape(-1)
    onehot = np.eye(e, dtype=np.int64)[flat]
    slot = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    return idx, slot < cap


def test_moe_config_is_the_reference_config():
    fields = [f.name for f in dataclasses.fields(JM.MoeConfig)]
    assert [f.name for f in dataclasses.fields(TM.MoeConfig)] == fields


@pytest.mark.parametrize("kind", ["grok", "arctic"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_matches_reference(dt, kind):
    """``moe`` on 2 x 12 tokens: the output (the arctic kind with its dense
    residual MLP) and the Switch aux loss (in f32 at 1e-6 relative; in
    bf16 both routers see the same bf16 activations in f32)."""
    jcfg, tcfg = _moe_cfgs(kind)
    jp, tp = _params(TM.init_moe, tcfg, seed=9)
    assert ("dense_mlp" in tp) == (kind == "arctic")
    assert tp["router"]["w"].shape == (128, 4)
    assert tp["w_out"].shape == (4, tcfg.d_ff, 128)
    jx, tx = _x((B, 12, 128), dt, seed=10)
    want, jaux = _j_moe(jp, jcfg, jx)
    with torch.inference_mode():
        got, aux = TM.moe(tp, tcfg, tx)
    assert got.dtype == TORCH_DT[dt] and aux.dtype == torch.float32
    _close(got, want, TOL[dt])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_ties_route_to_the_lower_expert():
    """Zero router weights: every token's probabilities tie, and both
    packages send each token to experts 0 and 1 with gates 1/2 (aux: 4 x
    the uniform 1/4 x all first choices on expert 0 = 1); rows with a
    three-way tie keep the lowest two of the tied experts."""
    jcfg, tcfg = _moe_cfgs("grok")
    jp, tp = _params(TM.init_moe, tcfg, seed=11)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    tp["router"]["w"] = torch.zeros_like(tp["router"]["w"])
    jx, tx = _x((B, 6, 128), "f32", seed=12)
    want, jaux = _j_moe(jp, jcfg, jx)
    with torch.inference_mode():
        got, aux = TM.moe(tp, tcfg, tx)
    _close(got, want, 1e-5)
    assert float(aux) == float(jaux) == pytest.approx(1.0)
    probs = torch.full((B * 6, 4), 0.25)
    vals, idx = TM.top_k_stable(probs, 2)
    assert idx.tolist() == [[0, 1]] * (B * 6)
    row = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.3, 0.1, 0.3, 0.3]])
    jv, ji = jax.lax.top_k(jnp.asarray(row.numpy()), 2)
    vals, idx = TM.top_k_stable(row, 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2], [0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_drops_the_reference_choices_at_capacity():
    """Every token prefers expert 0 (a large router weight on a feature
    all tokens share): past the capacity ceil(1.25 * 24 * 2 / 4) = 15 its
    later choices go to the overflow row and count nothing, in both
    packages alike."""
    jcfg, tcfg = _moe_cfgs("grok")
    jp, tp = _params(TM.init_moe, tcfg, seed=13)
    w = np.asarray(jp["router"]["w"]).copy()
    w[0, 0] = 50.0
    jp["router"]["w"] = jnp.asarray(w)
    tp["router"]["w"] = torch.from_numpy(w)
    x = np.random.default_rng(14).standard_normal((B, 12, 128)).astype(
        np.float32)
    x[..., 0] = 2.0
    want, _ = _j_moe(jp, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        got, _ = TM.moe(tp, tcfg, torch.from_numpy(x))
    _close(got, want, 1e-5)
    logits = x.reshape(-1, 128) @ w
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx, kept = _routing(probs, 2, 4, 15)
    assert (idx[:, 0] == 0).all()
    assert (~kept).sum() == 24 - 15
    # a dropped token's output holds only its second choice: remove the
    # kept tokens' first choices from both and the two still agree
    dropped = np.nonzero(~kept.reshape(-1, 2)[:, 0])[0]
    assert len(dropped) == 9
    np.testing.assert_allclose(_np(got).reshape(-1, 128)[dropped],
                               np.asarray(want).reshape(-1, 128)[dropped],
                               rtol=1e-5, atol=1e-5)

"""The port's GQA attention (``repro_torch.nn.attention``) and rotary
embedding (``repro_torch.nn.module.apply_rope``) against the JAX package
(``repro.nn.attention``, ``repro.nn.module``) on the same inputs and
parameters, made with numpy from a seed, in f32.

Tolerance: rtol = atol = 1e-5 everywhere.  The same f32 algorithm (the
reference computes attention in jnp, not in a Pallas kernel); only the
order of the einsums' and the softmax's sums, and the cos / sin of the
rotary angles, differ by an ulp.  The masks, and the positions a windowed
cache stores, are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro.nn import module as JM
from repro_torch import convert
from repro_torch.nn import attention as TA
from repro_torch.nn import module as TM

torch.set_num_threads(1)

TOL = 1e-5
B, S = 2, 16
# GQA: 4 query heads over 2 kv heads, head dim 8
CFG = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)


def _cfgs(**over):
    kw = dict(CFG, **over)
    return JA.AttnConfig(**kw), TA.AttnConfig(**kw)


def _params(jcfg, seed=0):
    jp, _ = JM.split_tree(JA.init_attention(jax.random.PRNGKey(seed), jcfg))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, convert.to_torch(jp, "cpu")


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _pos(b, s, offset=0):
    p = np.broadcast_to(np.arange(s, dtype=np.int32) + offset, (b, s))
    return jnp.asarray(p), torch.from_numpy(np.ascontiguousarray(p))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("rotary_dim,theta", [(8, 10000.0), (4, 10000.0),
                                              (8, 500000.0)],
                         ids=["full", "partial", "theta5e5"])
def test_apply_rope_matches_reference(rotary_dim, theta):
    jx, tx = _x((B, S, 3, 8), seed=rotary_dim)
    jp, tp = _pos(B, S, offset=500)
    want = JM.apply_rope(jx, jp, rotary_dim, theta)
    got = TM.apply_rope(tx, tp, rotary_dim, theta)
    _close(got, want)
    _close(TM.rope_freqs(rotary_dim, theta), JM.rope_freqs(rotary_dim, theta))


@pytest.mark.parametrize("mode,window,prefix,offset", [
    ("causal", None, 0, 0), ("causal", 4, 0, 0), ("prefix", None, 5, 0),
    ("full", None, 0, 0), ("causal", 3, 0, 7), ("prefix", 6, 3, 2)],
    ids=["causal", "window", "prefix", "full", "window-offset",
         "prefix-window"])
def test_make_mask_equals_reference(mode, window, prefix, offset):
    want = np.asarray(JA.make_mask(9, 16, mode, window, prefix, offset))
    got = TA.make_mask(9, 16, mode, window, prefix, offset).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q_chunk", [None, 4], ids=["whole", "q_chunk4"])
@pytest.mark.parametrize("mode,window,prefix", [
    ("causal", None, 0), ("causal", 5, 0), ("prefix", None, 6)],
    ids=["causal", "window", "prefix"])
def test_attention_matches_reference(mode, window, prefix, q_chunk):
    jcfg, tcfg = _cfgs(window=window)
    jp, tp = _params(jcfg)
    jx, tx = _x((B, S, CFG["d_model"]), seed=3)
    jpos, tpos = _pos(B, S)
    want = JA.attention(jp, jcfg, jx, jpos, mode, prefix, q_chunk=q_chunk)
    got = TA.attention(tp, tcfg, tx, tpos, mode, prefix, q_chunk=q_chunk)
    assert got.shape == (B, S, CFG["d_model"]) and got.dtype == torch.float32
    _close(got, want)


def test_q_chunk_equals_whole_sequence():
    """Inside the port: query blocks give the whole sequence's result."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0], seed=1)
    _, tx = _x((B, S, CFG["d_model"]), seed=4)
    _, tpos = _pos(B, S)
    torch.testing.assert_close(TA.attention(tp, tcfg, tx, tpos, q_chunk=8),
                               TA.attention(tp, tcfg, tx, tpos), rtol=TOL,
                               atol=TOL)


def test_caches_have_the_reference_layout():
    jcfg, tcfg = _cfgs()
    for jc, tc in ((JA.init_full_cache(B, 12, jcfg),
                    TA.init_full_cache(B, 12, tcfg, device="cpu")),
                   (JA.init_window_cache(B, 4, jcfg),
                    TA.init_window_cache(B, 4, tcfg, device="cpu"))):
        assert sorted(jc) == sorted(tc)
        for k in jc:
            np.testing.assert_array_equal(convert.to_numpy(tc[k]),
                                          np.asarray(jc[k]).view(
                                              convert.to_numpy(tc[k]).dtype))
            assert tuple(tc[k].shape) == jc[k].shape


@pytest.mark.parametrize("kind", ["full", "window"])
def test_attention_decode_matches_reference(kind):
    """Decode 7 tokens one at a time from an empty cache: a full cache of
    8 positions, or a ring of 4 (the ring wraps) with window 3; outputs
    and the whole cache after every step."""
    window = 3 if kind == "window" else None
    jcfg, tcfg = _cfgs(window=window)
    jp, tp = _params(jcfg, seed=2)
    if kind == "full":
        jc = JA.init_full_cache(B, 8, jcfg, jnp.float32)
        tc = TA.init_full_cache(B, 8, tcfg, torch.float32, device="cpu")
    else:
        jc = JA.init_window_cache(B, 4, jcfg, jnp.float32)
        tc = TA.init_window_cache(B, 4, tcfg, torch.float32, device="cpu")
    decode = jax.jit(JA.attention_decode, static_argnums=1)
    jx, tx = _x((B, 7, CFG["d_model"]), seed=5)
    for pos in range(7):
        want, jc = decode(jp, jcfg, jx[:, pos:pos + 1], jc,
                          jnp.asarray(pos, jnp.int32))
        got, tc = TA.attention_decode(tp, tcfg, tx[:, pos:pos + 1], tc, pos)
        assert got.shape == (B, 1, CFG["d_model"])
        _close(got, want)
        assert sorted(tc) == sorted(jc)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        if kind == "window":
            np.testing.assert_array_equal(tc["positions"].numpy(),
                                          np.asarray(jc["positions"]))


def test_decode_equals_full_attention():
    """Inside the port, the reference's cache-correctness property: decode
    after the first s - 1 keys equals full causal attention at s - 1."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0], seed=6)
    _, tx = _x((B, S, CFG["d_model"]), seed=7)
    _, tpos = _pos(B, S)
    full = TA.attention(tp, tcfg, tx, tpos)
    cache = TA.init_full_cache(B, S, tcfg, torch.float32, device="cpu")
    for pos in range(S):
        got, cache = TA.attention_decode(tp, tcfg, tx[:, pos:pos + 1], cache,
                                         pos)
        torch.testing.assert_close(got[:, 0], full[:, pos], rtol=TOL,
                                   atol=TOL)


def test_decode_outside_the_cache_raises():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    _, tx = _x((B, 1, CFG["d_model"]), seed=8)
    cache = TA.init_full_cache(B, 4, tcfg, torch.float32, device="cpu")
    with pytest.raises(IndexError, match="grow the cache"):
        TA.attention_decode(tp, tcfg, tx, cache, 4)


def test_config_is_the_reference_config():
    fields = [f.name for f in dataclasses.fields(JA.AttnConfig)]
    assert [f.name for f in dataclasses.fields(TA.AttnConfig)] == fields
    for frac in (1.0, 0.5, 0.3):
        j, t = _cfgs(rotary_frac=frac)
        assert t.rotary_dim == j.rotary_dim

"""The port's rwkv6 serving path against the JAX package, on the rwkv6-7b
SMOKE config (2 layers, d 128, 4 heads x 32, d_ff 448, vocab 512), with the
reference's parameters carried across by ``repro_torch.convert`` and the
inputs made with numpy from a seed.

Tolerances, each with its reason:

* 1e-4 (rtol = atol) in f32 (``dtype=float32``): the same f32 algorithm;
  PyTorch's and XLA's matmuls, reductions and the chunked scan sum in
  different orders, and two layers and a 128-wide layernorm amplify that
  to a few 1e-6;
* in bf16, normwise: max |port - reference| <= 2^-5 * max |reference|
  over each output, logits and state leaves alike (4 bf16 ulps of the
  largest element).  XLA and PyTorch round bf16 intermediates at
  different places (XLA may fuse an elementwise chain in f32 before the
  one rounding, PyTorch rounds each op), so single elements differ by a
  bf16 ulp of the activations they come from, which an elementwise
  tolerance cannot bound near zero; the largest ratio measured was
  0.014 (a 1-ulp step at 8-16 in a 9.06-sized output);
* 2e-3 for decode against forward inside the port, the reference's own
  decode-consistency tolerance (``tests/test_models_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import blocks as JB
from repro.models import build_model as jbuild_model
from repro.nn import ssm as JS
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.data import batch_source
from repro_torch.launch import serve
from repro_torch.models import blocks as TB
from repro_torch.models import build_model
from repro_torch.models.model import cast_for_serving
from repro_torch.nn import ssm as TS
from repro_torch.kernels import ops as tops
from repro_torch.tree import tree_map

torch.set_num_threads(2)

# one compiled program per shape instead of one per eager op
_j_block = jax.jit(JS.rwkv6_block, static_argnums=1)
_j_decode = jax.jit(JS.rwkv6_decode, static_argnums=1)
_j_layer_seq = jax.jit(JB.rwkv_layer_seq, static_argnums=1)
_j_layer_decode = jax.jit(JB.rwkv_layer_decode, static_argnums=1)

ARCH = "rwkv6-7b"
B = 2
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 1e-4, "bf16": 2.0 ** -5}


def _cfgs(dt):
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype=JAX_DT[dt],
                               remat=False)
    tcfg = dataclasses.replace(get_smoke(ARCH), dtype=TORCH_DT[dt],
                               remat=False)
    return jcfg, tcfg


_PARAMS = {}


def _params(dt):
    """The reference's parameters (numpy) and the port's copy of them."""
    if dt not in _PARAMS:
        jcfg, tcfg = _cfgs(dt)
        jp, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        _PARAMS[dt] = (np_params, convert.lm_params_to_torch(
            np_params, tcfg.n_layers, "cpu"))
    return _PARAMS[dt]


def _np(t):
    """A port tensor as f32 numpy (bf16 through its bits)."""
    a = convert.to_numpy(t)
    if t.dtype == torch.bfloat16:
        a = np.asarray(jnp.asarray(a.view(jnp.bfloat16), jnp.float32))
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    """f32 (tol 1e-4): elementwise rtol = atol = tol; bf16 (tol 2^-5):
    normwise, as the module's docstring says."""
    got = _np(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if tol >= TOL["bf16"]:
        assert got.shape == want.shape
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _x(shape, dt, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, JAX_DT[dt])
    return jx, convert.to_torch(np.asarray(jx), "cpu")


def _state(tcfg, seed):
    """A nonzero recurrent state for one layer, numpy f32."""
    rng = np.random.default_rng(seed)
    c = tcfg.rwkv_cfg()
    return {"S": rng.standard_normal((B, c.n_heads, c.head_dim, c.head_dim)
                                     ).astype(np.float32),
            "shift_t": rng.standard_normal((B, c.d_model)).astype(np.float32),
            "shift_c": rng.standard_normal((B, c.d_model)).astype(np.float32)}


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _close_state(got, want, tol):
    assert sorted(got) == sorted(want) == ["S", "shift_c", "shift_t"]
    for k in got:
        assert got[k].dtype == torch.float32
        _close(got[k], want[k], tol)


@pytest.mark.parametrize("seq", [32, 31], ids=["chunked", "recurrent"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_layer_and_decode_match_reference(dt, seq):
    """``rwkv6_block`` from a zero and a carried state, ``rwkv_layer_seq``
    and ``rwkv6_decode`` against the JAX functions; S = 32 takes the
    chunked branch, S = 31 the recurrence."""
    jcfg, tcfg = _cfgs(dt)
    np_params, t_params = _params(dt)
    jl, tl = _layer0(np_params["layers"]), tree_map(lambda a: a[0],
                                                    t_params["layers"])
    jx, tx = _x((B, seq, tcfg.d_model), dt, seed=seq)
    tol = TOL[dt]
    with torch.inference_mode():
        for st in (None, _state(tcfg, seed=seq + 1)):
            jst = None if st is None else jax.tree_util.tree_map(
                jnp.asarray, st)
            tst = None if st is None else convert.to_torch(st, "cpu")
            jy, jnew = _j_block(jl["blk"], jcfg.rwkv_cfg(), jx, jst)
            ty, tnew = TS.rwkv6_block(tl["blk"], tcfg.rwkv_cfg(), tx, tst)
            assert ty.dtype == TORCH_DT[dt]
            _close(ty, jy, tol)
            _close_state(tnew, jnew, tol)
        jy, jnew = _j_layer_seq(jl, jcfg, jx, jst)
        ty, tnew = TB.rwkv_layer_seq(tl, tcfg, tx, tst)
        _close(ty, jy, tol)
        _close_state(tnew, jnew, tol)
        jy, jnew = _j_layer_decode(jl, jcfg, jx[:, :1], jst)
        ty, tnew = TB.rwkv_layer_decode(tl, tcfg, tx[:, :1], tst)
        _close(ty, jy, tol)
        _close_state(tnew, jnew, tol)
        jy, _ = _j_decode(jl["blk"], jcfg.rwkv_cfg(), jx[:, :1], jst)
        ty, _ = TS.rwkv6_decode(tl["blk"], tcfg.rwkv_cfg(), tx[:, :1], tst)
        _close(ty, jy, tol)


def _tokens(seq, vocab, seed=7):
    t = np.random.default_rng(seed).integers(0, vocab, (B, seq))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("seq", [32, 31], ids=["chunked", "recurrent"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bundle_matches_reference(dt, seq):
    """``forward``, ``prefill`` (logits and all three state leaves) and
    ``decode_step`` against the reference bundle's."""
    jcfg, tcfg = _cfgs(dt)
    np_params, t_params = _params(dt)
    jb, tb = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    j_forward, j_prefill = jax.jit(jb.forward), jax.jit(jb.prefill)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jtok, ttok = _tokens(seq, tcfg.vocab)
    tol = TOL[dt]
    with torch.inference_mode():
        _close(tb.forward(t_params, {"tokens": ttok}),
               j_forward(jparams, {"tokens": jtok}), tol)
        jl, jc = j_prefill(jparams, {"tokens": jtok})
        tlog, tc = tb.prefill(t_params, {"tokens": ttok})
        assert tuple(tlog.shape) == (B, 1, tcfg.vocab)
        _close(tlog, jl, tol)
        assert {k: tuple(v.shape) for k, v in tc.items()} == {
            k: v.shape for k, v in jc.items()}
        _close_state(tc, jc, tol)
        jnext, ttok_next = _tokens(1, tcfg.vocab, seed=8)
        jd, jc2 = jax.jit(jb.decode_step)(jparams, jc, jnext,
                                          jnp.asarray(seq))
        # the port decodes from the reference's cache, carried across
        td, tc2 = tb.decode_step(
            t_params, convert.cache_to_torch(
                {k: np.asarray(v) for k, v in jc.items()}, "cpu"),
            ttok_next, seq)
        assert tuple(td.shape) == (B, tcfg.vocab)
        _close(td, jd, tol)
        _close_state(tc2, jc2, tol)


def test_decode_matches_forward():
    """The reference's decode-consistency property in f32: prefill s - 1
    tokens (31: the recurrence), decode token s, compare with ``forward``
    at position s - 1 (32 tokens: the chunked scan)."""
    _, tcfg = _cfgs("f32")
    _, t_params = _params("f32")
    tb = build_model(tcfg, device="cpu")
    _, tok = _tokens(32, tcfg.vocab, seed=9)
    with torch.inference_mode():
        full = tb.forward(t_params, {"tokens": tok})
        _, cache = tb.prefill(t_params, {"tokens": tok[:, :31]})
        logits, _ = tb.decode_step(t_params, cache, tok[:, 31:], 31)
    torch.testing.assert_close(logits, full[:, -1], rtol=2e-3, atol=2e-3)


def test_decode_after_chunked_prefill_matches_forward():
    """Prefill 32 tokens (the chunked scan's final state), decode 16, and
    hold each step's logits against ``forward`` over 48 tokens."""
    _, tcfg = _cfgs("f32")
    _, t_params = _params("f32")
    tb = build_model(tcfg, device="cpu")
    _, tok = _tokens(48, tcfg.vocab, seed=10)
    with torch.inference_mode():
        full = tb.forward(t_params, {"tokens": tok})
        _, cache = tb.prefill(t_params, {"tokens": tok[:, :32]})
        for i in range(32, 48):
            logits, cache = tb.decode_step(t_params, cache,
                                           tok[:, i:i + 1], i)
            torch.testing.assert_close(logits, full[:, i], rtol=2e-3,
                                       atol=2e-3)


def test_cast_for_serving_is_bitwise_the_f32_parameters():
    """bf16 copies of the leaves read as bf16 give the same bits."""
    _, tcfg = _cfgs("bf16")
    _, t_params = _params("bf16")
    cast = cast_for_serving(tcfg, t_params)
    assert cast["embed"]["table"].dtype == torch.bfloat16
    assert cast["layers"]["blk"]["ck"]["w"].dtype == torch.bfloat16
    assert cast["layers"]["blk"]["mu"].dtype == torch.bfloat16
    for name in ("w0", "u"):
        assert cast["layers"]["blk"][name].dtype == torch.float32
    assert cast["layers"]["ln"]["scale"].dtype == torch.float32
    assert t_params["layers"]["blk"]["ck"]["w"].dtype == torch.float32
    tb = build_model(tcfg, device="cpu")
    _, tok = _tokens(32, tcfg.vocab, seed=11)
    with torch.inference_mode():
        l32, c32 = tb.prefill(t_params, {"tokens": tok})
        l16, c16 = tb.prefill(cast, {"tokens": tok})
        d32, _ = tb.decode_step(t_params, c32, tok[:, :1], 32)
        d16, _ = tb.decode_step(cast, c16, tok[:, :1], 32)
    assert torch.equal(l32, l16) and torch.equal(d32, d16)
    assert all(torch.equal(c32[k], c16[k]) for k in c32)


def test_convert_checks_trees_and_round_trips_the_cache():
    np_params, _ = _params("f32")
    with pytest.raises(ValueError, match="stacked"):
        convert.lm_params_to_torch(np_params, 3, "cpu")
    with pytest.raises(ValueError, match="LM parameter"):
        convert.lm_params_to_torch({"embed": np_params["embed"]}, 2, "cpu")
    cache = {k: np.stack([v, v]) for k, v in _state(_cfgs("f32")[1],
                                                    seed=3).items()}
    back = convert.cache_to_numpy(convert.cache_to_torch(cache, "cpu"))
    assert all(np.array_equal(back[k], cache[k]) for k in cache)
    with pytest.raises(ValueError, match="keys"):
        convert.cache_to_torch({"S": cache["S"]}, "cpu")


def test_configs_are_the_reference_values():
    from repro.configs import get_config as jget_config
    for port, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (get_smoke(ARCH), jget_smoke(ARCH))):
        fields = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(port)] == fields
        for name in fields:
            if name != "dtype":
                assert getattr(port, name) == getattr(ref, name), name
        assert port.dtype == torch.bfloat16
        assert port.rwkv_cfg().n_heads == ref.rwkv_cfg().n_heads


def test_unported_parts_raise_naming_the_roadmap():
    """Every architecture builds since the decoder and encoder-decoder
    slice (the MLA and MoE accessors, the dense family), and every
    family's LM loss runs since the LM training slice (ROADMAP queue 1
    item 13): what still raises is an unknown arch or family."""
    cfg = get_smoke(ARCH)
    assert cfg.mla_cfg().kv_lora_rank == 256 and cfg.moe_cfg().top_k == 2
    assert get_config("tinyllama-1.1b").family == "dense"
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="mystery"), device="cpu")
    for arch in ARCHS:
        smoke = get_smoke(arch)
        bundle = build_model(smoke, device="cpu")
        gen = torch.Generator().manual_seed(0)
        batch = batch_source(smoke, 1, 2, 32, device="cpu")(gen, 0)
        loss = bundle.loss(bundle.init(gen), {k: v[0]
                                              for k, v in batch.items()})
        assert loss.dtype == torch.float32 and loss.dim() == 0
        assert bool(torch.isfinite(loss)), arch


def test_serve_smoke_on_cpu(capsys):
    tops.reset_launches()
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "32",
                       "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "[prefill] rwkv6-smoke batch=2 prompt=32" in out
    assert "[decode] 4 tokens x 2 seqs" in out
    ids = eval(out.split("[sample ids]")[1].strip().splitlines()[0])
    assert len(ids) == 5 and all(0 <= i < 512 for i in ids)
    assert tops.LAUNCHES["rwkv6_chunk"] == 0   # plain version on the CPU


def test_generate_returns_ids_in_range_and_the_cache():
    cfg, bundle, params = serve.load(ARCH, smoke=True, device="cpu", seed=3)
    tokens = serve.make_prompt(cfg, 3, 16, "cpu", seed=4)
    out = serve.generate(bundle, params, tokens, 3)
    assert tuple(out["ids"].shape) == (3, 4)
    assert bool(((out["ids"] >= 0) & (out["ids"] < cfg.vocab)).all())
    assert tuple(out["cache"]["S"].shape) == (cfg.n_layers, 3, 4, 32, 32)
    assert torch.isfinite(out["logits"]).all()

"""The port's zamba2 serve entry point (``repro_torch.launch.serve``) and
``cast_for_serving`` on the zamba2-7b SMOKE config, with the parameters
and tokens of ``tests/test_torch_zamba2_model.py``: greedy ids against the reference
serve loop, decode against ``forward``, and the prompt length at which
the reference's serve entry point fails.

Tolerances: ids exactly equal (f32); 2e-3 for decode against forward
inside the port, the reference's own decode-consistency tolerance
(``tests/test_models_smoke.py``); ``cast_for_serving`` bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import build_model as jbuild_model
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.model import cast_for_serving
from test_torch_zamba2_model import ARCH, B, _cfgs, _params, _tokens

torch.set_num_threads(2)


def test_decode_after_chunked_prefill_matches_forward():
    """f32: prefill 64 tokens (the chunked scan's final state and the
    collected attention caches), decode 64, and hold each step's logits
    against ``forward`` over 128 tokens (two chunks, the second started
    from the first's state)."""
    _, tcfg = _cfgs("f32")
    _, t_params = _params()
    tb = build_model(tcfg, device="cpu")
    _, tok = _tokens(128, tcfg.vocab, seed=10)
    with torch.inference_mode():
        full = tb.forward(t_params, {"tokens": tok})
        _, cache = tb.prefill(t_params, {"tokens": tok[:, :64]})
        cache = serve.grow_cache(cache, 64)
        for i in range(64, 128):
            logits, cache = tb.decode_step(t_params, cache,
                                           tok[:, i:i + 1], i)
            torch.testing.assert_close(logits, full[:, i], rtol=2e-3,
                                       atol=2e-3)


def _reference_serve_ids(jcfg, np_params, tokens, gen):
    """The loop of ``repro.launch.serve.main`` (prefill, grow every leaf
    whose axis 2 is the prompt length, greedy ``decode_step``s) on given
    parameters and prompt."""
    jb = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    s = tokens.shape[1]
    logits, cache = jax.jit(jb.prefill)(params, {"tokens": tokens})

    def grow(leaf):
        if leaf.ndim >= 3 and leaf.shape[2] == s:
            pad = [(0, 0)] * leaf.ndim
            pad[2] = (0, gen)
            return jnp.pad(leaf, pad)
        return leaf

    cache = jax.tree_util.tree_map(grow, cache)
    decode = jax.jit(jb.decode_step)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    outs = [tok]
    for i in range(gen):
        logits_d, cache = decode(params, cache, tok,
                                 jnp.asarray(s + i, jnp.int32))
        tok = jnp.argmax(logits_d, axis=-1).astype(jnp.int32)[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1))


def test_generate_gives_the_reference_serve_loops_ids():
    """``serve.generate`` at prompt 64 (the chunked scan) in f32: the same
    greedy ids as the reference's serve loop on the same parameters."""
    jcfg, tcfg = _cfgs("f32")
    np_params, t_params = _params()
    jtok, ttok = _tokens(64, tcfg.vocab, seed=12)
    want = _reference_serve_ids(jcfg, np_params, jtok, 6)
    tb = build_model(tcfg, device="cpu")
    out = serve.generate(tb, t_params, ttok, 6)
    np.testing.assert_array_equal(out["ids"].numpy(), want)


def test_prompt_as_long_as_the_heads_serves_and_matches_forward():
    """Prompt length 8, the smoke config's number of Mamba heads: the
    reference's serve entry point pads the mamba state ``h`` along its heads there
    and fails (ROADMAP queue 3); the port grows the attention caches by
    key, serves, and each greedy step's logits equal ``forward`` over the
    prompt and the ids so far (f32, 2e-3)."""
    _, tcfg = _cfgs("f32")
    _, t_params = _params()
    assert tcfg.mamba_cfg().n_heads == 8
    _, ttok = _tokens(8, tcfg.vocab, seed=13)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jserve.main(["--arch", ARCH, "--smoke", "--prompt-len", "8",
                     "--gen", "2", "--batch", "1"])
    tb = build_model(tcfg, device="cpu")
    out = serve.generate(tb, t_params, ttok, 4)
    ids = out["ids"]
    assert tuple(ids.shape) == (B, 5)
    assert tuple(out["cache"]["attn"]["k"].shape)[2] == 8 + 4
    assert tuple(out["cache"]["mamba"]["h"].shape) == (5, B, 8, 32, 16)
    with torch.inference_mode():
        seq = torch.cat([ttok, ids[:, :-1]], dim=1)
        full = tb.forward(t_params, {"tokens": seq})
        torch.testing.assert_close(out["logits"], full[:, -1], rtol=2e-3,
                                   atol=2e-3)
    assert torch.equal(ids, torch.argmax(full[:, 7:], dim=-1))


def test_cast_for_serving_is_bitwise_the_f32_parameters():
    """bf16 copies of the leaves read as bf16 give the same bits; the
    leaves read in f32 stay f32."""
    _, tcfg = _cfgs("bf16")
    _, t_params = _params()
    cast = cast_for_serving(tcfg, t_params)
    blk = cast["mamba"]["blk"]
    for name in ("w_in", "w_out"):
        assert blk[name]["w"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b"):
        assert blk[name].dtype == torch.bfloat16
    for name in ("a_log", "dt_bias", "d_skip"):
        assert blk[name].dtype == torch.float32
    assert blk["out_norm"]["scale"].dtype == torch.float32
    assert cast["mamba"]["ln"]["scale"].dtype == torch.float32
    sh = cast["shared_attn"]
    for name in ("wq", "wk", "wv", "wo"):
        assert sh["attn"][name]["w"].dtype == torch.bfloat16
    for name in ("w_in", "w_gate", "w_out"):
        assert sh["ffn"][name]["w"].dtype == torch.bfloat16
    assert sh["ln1"]["scale"].dtype == torch.float32
    assert cast["embed"]["table"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"].dtype == torch.float32
    assert t_params["mamba"]["blk"]["w_in"]["w"].dtype == torch.float32
    tb = build_model(tcfg, device="cpu")
    _, tok = _tokens(64, tcfg.vocab, seed=11)
    with torch.inference_mode():
        l32, c32 = tb.prefill(t_params, {"tokens": tok})
        l16, c16 = tb.prefill(cast, {"tokens": tok})
        c32, c16 = serve.grow_cache(c32, 1), serve.grow_cache(c16, 1)
        d32, n32 = tb.decode_step(t_params, c32, tok[:, :1], 64)
        d16, n16 = tb.decode_step(cast, c16, tok[:, :1], 64)
    assert torch.equal(l32, l16) and torch.equal(d32, d16)
    for part in ("mamba", "attn"):
        assert all(torch.equal(n32[part][k], n16[part][k])
                   for k in n32[part])


def test_serve_smoke_on_cpu(capsys):
    tops.reset_launches()
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "64",
                       "--gen", "8"]) == 0
    out = capsys.readouterr().out
    assert "[prefill] zamba2-smoke batch=2 prompt=64" in out
    assert "[decode] 8 tokens x 2 seqs" in out
    ids = eval(out.split("[sample ids]")[1].strip().splitlines()[0])
    assert len(ids) == 9 and all(0 <= i < 512 for i in ids)
    assert set(tops.LAUNCHES.values()) == {0}   # plain versions on the CPU


def test_load_draws_the_hybrid_on_the_device_asked():
    cfg, bundle, params = serve.load(ARCH, smoke=True, device="cpu", seed=3)
    assert params["mamba"]["blk"]["w_in"]["w"].shape == (5, 128, 2 * 256
                                                        + 2 * 16 + 8)
    assert params["shared_attn"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    tokens = serve.make_prompt(cfg, 3, 16, "cpu", seed=4)
    out = serve.generate(bundle, params, tokens, 3)
    assert tuple(out["ids"].shape) == (3, 4)
    assert bool(((out["ids"] >= 0) & (out["ids"] < cfg.vocab)).all())
    assert tuple(out["cache"]["attn"]["v"].shape) == (2, 3, 19, 4, 32)
    assert torch.isfinite(out["logits"].float()).all()


def test_decode_step_uses_up_its_cache():
    """The hybrid ``decode_step`` writes the new key and value into the
    attention cache it is given and returns those same tensors (the
    reference returns a copy); the mamba states come back as new tensors
    and the ones passed in are left as they were."""
    _, tcfg = _cfgs("f32")
    _, t_params = _params()
    tb = build_model(tcfg, device="cpu")
    _, tok = _tokens(64, tcfg.vocab, seed=12)
    with torch.inference_mode():
        _, cache = tb.prefill(t_params, {"tokens": tok})
        cache = serve.grow_cache(cache, 1)
        before = {p: {k: v.clone() for k, v in cache[p].items()}
                  for p in cache}
        _, out = tb.decode_step(t_params, cache, tok[:, :1], 64)
    for k in ("k", "v"):
        assert out["attn"][k] is cache["attn"][k]
        assert torch.equal(cache["attn"][k][:, :, :64],
                           before["attn"][k][:, :, :64])
        assert not torch.equal(cache["attn"][k][:, :, 64],
                               before["attn"][k][:, :, 64])
    for k in ("h", "conv"):
        assert out["mamba"][k] is not cache["mamba"][k]
        assert torch.equal(cache["mamba"][k], before["mamba"][k])
        assert not torch.equal(out["mamba"][k], before["mamba"][k])

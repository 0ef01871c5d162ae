"""The port's serve entry point (``repro_torch.launch.serve``) and
``cast_for_serving`` on the eight smoke configs this slice adds (the dense,
MLA, MoE and VLM decoders and the encoder-decoder), with the parameters and
batches of ``tests/lm_parity.py``: greedy ids against the reference's
serve loop (its caches grown as its own decode-consistency test grows
them), the family batches of ``make_batch``, ``load``'s per-leaf draw,
``grow_cache`` by key, and the hybrid's ``window`` options.

Tolerances: ids exactly equal (f32); ``load`` and ``cast_for_serving``
bitwise; the hybrid's window options normwise 1e-4 in f32 (the bundle
gate of ``tests/test_torch_zamba2_model.py``).
"""

import dataclasses
import pathlib
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (B, BUNDLE_TOL, DECODERS, ENCDEC, batch, cfgs, close,
                       flat, grow, jbundle, jparams, params)
from repro.configs import ARCHS
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.model import cast_for_serving
from repro_torch.tree import tree_flatten, tree_leaves

torch.set_num_threads(2)

NEW = DECODERS + [ENCDEC]


def cfg_of(arch):
    """The port's smoke config of ``arch`` (bf16)."""
    return cfgs(arch, "bf16")[1]


def _reference_serve_ids(jcfg, np_params, jb_in, s, gen):
    """The loop of ``repro.launch.serve.main`` (prefill, grow, greedy
    ``decode_step``s at ``s + i``) with every family's self-attention
    caches grown (the encoder-decoder's too, which ``main`` leaves out:
    ``tests/test_torch_encdec.py`` pins that)."""
    _, _, pre, dec = jbundle(jcfg)
    jp = jparams(np_params)
    logits, cache = pre(jp, jb_in)
    cache = grow(cache, gen, s)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    outs = [tok]
    for i in range(gen):
        logits, cache = dec(jp, cache, tok, jnp.asarray(s + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1))


@pytest.mark.parametrize("arch", NEW)
def test_generate_gives_the_reference_serve_loops_ids(arch):
    """``serve.generate`` in f32 over 20 prefilled positions (the VLM's 8
    patches among them, the encoder-decoder's 8 frames beside) and 6
    decode steps: the reference loop's ids."""
    jcfg, tcfg = cfgs(arch, "f32")
    np_params, t_params = params(arch)
    jb_in, tb_in = batch(tcfg, 20, seed=21)
    want = _reference_serve_ids(jcfg, np_params, jb_in, 20, 6)
    out = serve.generate(build_model(tcfg, device="cpu"), t_params, tb_in, 6)
    assert tuple(out["ids"].shape) == (B, 7)
    np.testing.assert_array_equal(out["ids"].numpy(), want)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b", ENCDEC])
def test_make_batch_builds_the_reference_batch(arch):
    """The reference serve entry point's batch: a VLM's ``prompt_len -
    n_prefix`` ids and ``(B, n_prefix, frontend_dim)`` patches; an
    encoder-decoder's ``(B, prompt_len, frontend_dim)`` frames and
    ``prompt_len`` ids; else the ids of ``make_prompt``; reproducible from
    the seed; a VLM prompt no longer than its prefix refused."""
    cfg = cfg_of(arch)
    got = serve.make_batch(cfg, 3, 24, "cpu", seed=5)
    text = 24 - cfg.n_prefix if cfg.family == "vlm" else 24
    assert tuple(got["tokens"].shape) == (3, text)
    assert got["tokens"].dtype == torch.int64
    assert bool(((got["tokens"] >= 0) & (got["tokens"] < cfg.vocab)).all())
    extra = {"vlm": ("patches", (3, 8, 64)),
             "encdec": ("frames", (3, 24, 64))}.get(cfg.family)
    assert sorted(got) == sorted(["tokens"] + ([extra[0]] if extra else []))
    if extra:
        assert tuple(got[extra[0]].shape) == extra[1]
        assert got[extra[0]].dtype == torch.float32
    else:
        assert torch.equal(got["tokens"],
                           serve.make_prompt(cfg, 3, 24, "cpu", seed=5))
    again = serve.make_batch(cfg, 3, 24, "cpu", seed=5)
    assert all(torch.equal(got[k], again[k]) for k in got)
    if cfg.family == "vlm":
        with pytest.raises(ValueError, match="patch tokens"):
            serve.make_batch(cfg, 3, 8, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_load_is_bitwise_cast_for_serving_of_init(arch):
    """``load`` draws each leaf and casts it at once (``serving_dtypes``,
    found on meta tensors): every leaf, its dtype and its bits, equals
    ``cast_for_serving(cfg, bundle.init(generator))`` from the same
    seed."""
    cfg, bundle, got = serve.load(arch, smoke=True, device="cpu", seed=4)
    want = cast_for_serving(cfg, bundle.init(torch.Generator().manual_seed(4)))
    g_leaves, g_def = tree_flatten(got)
    w_leaves, w_def = tree_flatten(want)
    assert g_def == w_def
    for a, b in zip(g_leaves, w_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    dtypes = serve.serving_dtypes(cfg, bundle)
    assert len(dtypes) == len(g_leaves)
    assert torch.bfloat16 in dtypes and torch.float32 in dtypes


@pytest.mark.parametrize("arch", NEW)
def test_cast_for_serving_is_bitwise_the_f32_parameters(arch):
    """bf16 copies of the leaves read as bf16 (dense weights, MLA's
    projections, the expert stacks and the dense residual, the projector,
    the adapter, the embedding and an untied head); the leaves read in
    f32 stay f32 (the router, every norm, MLA's ``q_norm`` and
    ``kv_norm``); prefill and a decode step on the copies are bitwise
    those on the f32 parameters."""
    _, tcfg = cfgs(arch, "bf16")
    _, t_params = params(arch)
    cast = cast_for_serving(tcfg, t_params)
    flat_cast = flat(cast)
    for path, t in flat_cast.items():
        want = torch.float32 if _is_f32_leaf(path) else torch.bfloat16
        assert t.dtype == want, (path, t.dtype)
    assert all(t.dtype == torch.float32 for t in tree_leaves(t_params))
    tb = build_model(tcfg, device="cpu")
    _, tb_in = batch(tcfg, 20, seed=22)
    with torch.inference_mode():
        l32, c32 = tb.prefill(t_params, tb_in)
        l16, c16 = tb.prefill(cast, tb_in)
        nxt = tb_in["tokens"][:, :1]
        d32, n32 = tb.decode_step(t_params, serve.grow_cache(c32, 1), nxt,
                                  20)
        d16, n16 = tb.decode_step(cast, serve.grow_cache(c16, 1), nxt, 20)
    assert torch.equal(l32, l16) and torch.equal(d32, d16)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(n32),
                                                 tree_leaves(n16)))


def _is_f32_leaf(path):
    """The leaves the reference reads in f32: the router's weight, and
    every norm's scale and bias (``ln*``, ``final_norm``, ``q_norm``,
    ``kv_norm``)."""
    parts = path.split(".")
    return ("router" in parts or "final_norm" in parts
            or any(p.startswith("ln") or p.endswith("_norm") for p in parts))


@pytest.mark.parametrize("arch", NEW)
def test_serve_main_smoke_on_cpu(arch, capsys):
    tops.reset_launches()
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "24",
                       "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[prefill] {cfg_of(arch).name} batch=2 prompt=24" in out
    assert "[decode] 4 tokens x 2 seqs" in out
    ids = eval(out.split("[sample ids]")[1].strip().splitlines()[0])
    assert len(ids) == 5 and all(0 <= i < 512 for i in ids)
    assert set(tops.LAUNCHES.values()) == {0}   # no kernel on these paths


def test_serve_main_default_arch_is_the_reference(capsys):
    """With no ``--arch`` both serve entry points take tinyllama-1.1b
    (ROADMAP queue 3 item 19: the port's default was rwkv6-7b)."""
    from repro.launch import serve as jserve

    prefill = re.compile(r"^\[prefill\] (\S+) batch=", re.M)
    assert jserve.main(["--smoke", "--gen", "2"]) == 0
    want = prefill.search(capsys.readouterr().out).group(1)
    assert serve.main(["--smoke", "--gen", "2", "--device", "cpu"]) == 0
    got = prefill.search(capsys.readouterr().out).group(1)
    assert got == want == cfg_of("tinyllama-1.1b").name


@pytest.mark.parametrize("arch", ["zamba2-7b", "minicpm3-4b"])
def test_serve_batched_example_runs_on_cpu(arch, monkeypatch, capsys):
    """``examples/serve_batched_torch.py --device cpu`` serves the smoke
    config (the hybrid by default, another with ``--arch``)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "serve_batched_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu",
                                      "--arch", arch])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(path), run_name="__main__")
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert f"[prefill] {cfg_of(arch).name} batch=2 prompt=32" in out
    assert "[decode] 12 tokens x 2 seqs" in out


def test_grow_cache_grows_by_key():
    """Each cache format: a decoder's ``k`` / ``v`` and MLA's ``ckv`` /
    ``krope`` grow on the sequence axis; the encoder-decoder's ``self``
    grows and its ``cross`` does not; the hybrid's ``attn`` grows and its
    mamba states do not (``h`` as long as the prompt included); a windowed
    ring and a recurrent state come back as they are."""
    def bundle(arch, **over):
        return build_model(dataclasses.replace(cfg_of(arch), **over),
                           device="cpu")

    dense = serve.grow_cache(bundle("tinyllama-1.1b").init_cache(B, 10), 3)
    assert {k: tuple(v.shape)[2] for k, v in dense.items()} == {"k": 13,
                                                                "v": 13}
    mla = serve.grow_cache(bundle("minicpm3-4b").init_cache(B, 10), 3)
    assert {k: tuple(v.shape)[2] for k, v in mla.items()} == {"ckv": 13,
                                                              "krope": 13}
    ring = bundle("h2o-danube-3-4b").init_cache(B, 40)
    assert serve.grow_cache(ring, 3) is ring
    ed = serve.grow_cache(bundle(ENCDEC).init_cache(B, 10, enc_len=10), 3)
    assert tuple(ed["self"]["k"].shape)[2] == 13
    assert tuple(ed["cross"]["v"].shape)[2] == 10
    hy = bundle("zamba2-7b").init_cache(B, 8)
    grown = serve.grow_cache(hy, 3)
    assert tuple(grown["attn"]["k"].shape)[2] == 11
    assert grown["mamba"]["h"] is hy["mamba"]["h"]
    rw = bundle("rwkv6-7b").init_cache(B)
    assert serve.grow_cache(rw, 3) is rw


@pytest.mark.parametrize("arch", ["minicpm3-4b", "grok-1-314b", ENCDEC])
def test_decode_step_uses_up_its_cache(arch):
    """``decode_step`` writes the new entries into the stacked cache it is
    given (MLA's latent, GQA's keys and values, the encoder-decoder's self
    cache) and returns those same tensors."""
    _, tcfg = cfgs(arch, "f32")
    _, t_params = params(arch)
    tb = build_model(tcfg, device="cpu")
    _, tb_in = batch(tcfg, 12, seed=23)
    with torch.inference_mode():
        _, cache = tb.prefill(t_params, tb_in)
        cache = serve.grow_cache(cache, 1)
        before = [t.clone() for t in tree_leaves(cache)]
        _, out = tb.decode_step(t_params, cache, tb_in["tokens"][:, :1], 12)
    for a, b, old in zip(tree_leaves(out), tree_leaves(cache), before):
        assert a is b
        assert torch.equal(a[:, :, :10], old[:, :, :10])
    written = [not torch.equal(a[:, :, 12], old[:, :, 12])
               for a, old in zip(tree_leaves(out), before)
               if a.shape[2] == 13]
    assert written and all(written)


def test_hybrid_takes_the_window_options():
    """zamba2's ``prefill`` and ``decode_step`` take ``window`` as the
    reference's do (dropped in an earlier slice, back now), against the
    reference's in f32 at 1e-4: a prefill of 24 tokens at window 8 (not
    the config's unwindowed result), and a decode step at window 8 after
    6 tokens (within the window, where the two decode masks agree:
    ``tests/test_torch_decoder_model.py`` pins the difference past it)."""
    from test_torch_zamba2_model import _cfgs, _grow, _params, _tokens

    jcfg, tcfg = _cfgs("f32")
    np_params, t_params = _params()
    jtok, ttok = _tokens(24, tcfg.vocab, seed=24)
    jb, _, _, _ = jbundle(jcfg)
    jp = jparams(np_params)
    jpre = jax.jit(jb.prefill, static_argnames="window")
    jl, _ = jpre(jp, {"tokens": jtok}, window=8)
    _, jc = jpre(jp, {"tokens": jtok[:, :6]}, window=8)
    jd, _ = jax.jit(jb.decode_step, static_argnames="window")(
        jp, _grow(jc, 1), jtok[:, 6:7], jnp.asarray(6, jnp.int32), window=8)
    tb = build_model(tcfg, device="cpu")
    with torch.inference_mode():
        tl, _ = tb.prefill(t_params, {"tokens": ttok}, window=8)
        _, tc = tb.prefill(t_params, {"tokens": ttok[:, :6]}, window=8)
        td, _ = tb.decode_step(t_params, serve.grow_cache(tc, 1),
                               ttok[:, 6:7], 6, window=8)
        plain, _ = tb.prefill(t_params, {"tokens": ttok})
    close(tl, jl, BUNDLE_TOL["f32"])
    close(td, jd, BUNDLE_TOL["f32"])
    assert float((tl - plain).abs().max()) > 1e-3
    ring = tb.init_cache(B, 24, torch.float32, window=8)
    assert tuple(ring["attn"]["positions"].shape) == (2, B, 8)

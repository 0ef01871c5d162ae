"""The port's LM loss (``repro_torch.nn.module.cross_entropy_loss`` and each
family's ``bundle.loss``) against the JAX package's, on the smoke configs
of all ten architectures: the loss and every gradient leaf, from the same
converted parameters and the same numpy batch.

Gates: the cross-entropy within 1e-6 of the reference's; in f32 the
bundle's loss within 1e-5 relative and each gradient leaf within 1e-4
normwise (``tests/lm_parity.py``'s bundle gate); in bf16 the port's RMS
error from the reference's f32 gradient within 0.5 to 1.25 times the
reference's own bf16 RMS error from it (that file's RMS-ratio gate), over
all leaves at once.  The sequence lengths make rwkv6 (chunk 16) and the
hybrid (chunk 64) take their chunked scans, which the loss runs in their
plain form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from lm_parity import (B, DECODERS, ENCDEC, batch, cfgs, flat, jbuild_model,
                       jparams, npf, params)
from repro.nn.module import cross_entropy_loss as jce
from repro_torch.models import build_model
from repro_torch.nn.module import cross_entropy_loss

torch.set_num_threads(2)

ARCHS = DECODERS + [ENCDEC, "rwkv6-7b", "zamba2-7b"]
SEQ = {"rwkv6-7b": 32, "zamba2-7b": 64}


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_is_the_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(jce(jnp.asarray(logits), jnp.asarray(labels),
                     None if mask is None else jnp.asarray(mask)))
    got = float(cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6 * abs(want)
    if masked:   # an all-zero mask divides by 1, not by 0
        zero = cross_entropy_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.zeros(2, 7))
        assert float(zero) == 0.0


def test_cross_entropy_of_bf16_logits_is_f32():
    logits = torch.randn(2, 5, 11, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 11, (2, 5), dtype=torch.int32)
    out = cross_entropy_loss(logits.to(torch.bfloat16), labels)
    assert out.dtype == torch.float32
    want = cross_entropy_loss(logits.to(torch.bfloat16).float(), labels)
    assert torch.equal(out, want)


_JGRAD = {}


def reference_loss_and_grad(jcfg, np_params, jb_in):
    if jcfg not in _JGRAD:
        _JGRAD[jcfg] = jax.jit(jax.value_and_grad(jbuild_model(jcfg).loss))
    loss, grads = _JGRAD[jcfg](jparams(np_params), jb_in)
    return loss, flat(grads)


def port_loss_and_grad(tcfg, t_params, tb_in):
    tb = build_model(tcfg, device="cpu")
    grads, loss = grad_and_value(tb.loss)(t_params, tb_in)
    return loss, flat(grads)


def _normwise(got, want):
    got, want = npf(got), np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_the_reference_f32(arch):
    jcfg, tcfg = cfgs(arch, "f32")
    np_params, t_params = params(arch)
    jb_in, tb_in = batch(tcfg, SEQ.get(arch, 24))
    jl, jg = reference_loss_and_grad(jcfg, np_params, jb_in)
    tl, tg = port_loss_and_grad(tcfg, t_params, tb_in)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert sorted(tg) == sorted(jg)
    errs = {k: _normwise(tg[k], jg[k]) for k in jg if np.any(jg[k])}
    assert errs and max(errs.values()) <= 1e-4, max(errs.items(),
                                                    key=lambda kv: kv[1])
    # a leaf the reference's gradient leaves at 0 is 0 in the port too
    for k in set(jg) - set(errs):
        assert not torch.any(tg[k]), k


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "grok-1-314b",
                                  "paligemma-3b", "rwkv6-7b"])
def test_loss_and_gradient_bf16_rms_ratio(arch):
    jcfg, tcfg = cfgs(arch, "bf16")
    jcfg32, _ = cfgs(arch, "f32")
    np_params, t_params = params(arch)
    jb_in, tb_in = batch(tcfg, SEQ.get(arch, 24))
    _, jg = reference_loss_and_grad(jcfg, np_params, jb_in)
    _, jg32 = reference_loss_and_grad(jcfg32, np_params, jb_in)
    tl, tg = port_loss_and_grad(tcfg, t_params, tb_in)
    assert tl.dtype == torch.float32 and bool(torch.isfinite(tl))
    keys = sorted(jg32)
    ref32 = np.concatenate([np.ravel(jg32[k]) for k in keys])
    own = np.concatenate([np.ravel(np.asarray(jg[k], np.float32))
                          for k in keys])
    ours = np.concatenate([np.ravel(npf(tg[k])) for k in keys])
    e_own = np.linalg.norm(own - ref32) / np.linalg.norm(ref32)
    e_ours = np.linalg.norm(ours - ref32) / np.linalg.norm(ref32)
    assert 0.5 * e_own <= e_ours <= 1.25 * e_own, (e_ours, e_own)


def test_loss_batch_is_the_forward_layout():
    """``loss`` takes the batch ``forward`` takes: B sequences, the VLM's
    patches before its text."""
    _, tcfg = cfgs("paligemma-3b", "f32")
    _, tb_in = batch(tcfg, 24)
    assert tuple(tb_in["tokens"].shape) == (B, 24 - tcfg.n_prefix)
    _, t_params = params("paligemma-3b")
    tb = build_model(tcfg, device="cpu")
    with torch.no_grad():
        logits = tb.forward(t_params, tb_in)[:, tcfg.n_prefix:]
        want = cross_entropy_loss(logits[:, :-1], tb_in["tokens"][:, 1:])
        assert torch.allclose(tb.loss(t_params, tb_in), want, rtol=1e-6)

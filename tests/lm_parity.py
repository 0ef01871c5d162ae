"""Shared helpers of the LM parity tests (``tests/test_torch_decoder_model.py``,
``tests/test_torch_encdec.py``, ``tests/test_torch_decoder_serve.py``): one
set of f32 parameters drawn by the port's ``init`` from a seed, handed to
the reference as numpy and carried into the port by ``repro_torch.convert``
(the reference's own ``init`` runs op by op and takes seconds); batches made
with numpy from a seed; normwise and RMS comparisons.

The bundle-level gates are those of ``tests/test_torch_zamba2_model.py``
(its module docstring gives the reasons): f32 normwise 1e-4 a bundle and
1e-5 a block or layer; bf16 2^-5 a block or layer, and for a whole bundle
the port's bf16 RMS error from the reference's f32 result within 0.5 to
1.25 times the reference's own bf16 RMS error from it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import build_model
from repro_torch.tree import tree_map

B = 2
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -5}
BUNDLE_TOL = {"f32": 1e-4, "bf16": (0.5, 1.25)}
DECODERS = ["tinyllama-1.1b", "chatglm3-6b", "h2o-danube-3-4b",
            "minicpm3-4b", "grok-1-314b", "arctic-480b", "paligemma-3b"]
ENCDEC = "seamless-m4t-medium"


def cfgs(arch, dt, **over):
    """(reference, port) smoke configs of ``arch`` in ``dt``."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=JAX_DT[dt],
                               remat=False, **over)
    tcfg = dataclasses.replace(get_smoke(arch), dtype=TORCH_DT[dt],
                               remat=False, **over)
    return jcfg, tcfg


_PARAMS = {}


def params(arch, seed=0):
    """f32 parameters of ``arch``'s smoke config: (numpy, port tensors);
    the same for both dtypes (every use casts)."""
    if (arch, seed) not in _PARAMS:
        _, tcfg = cfgs(arch, "f32")
        drawn = build_model(tcfg, device="cpu").init(
            torch.Generator().manual_seed(seed))
        np_params = convert.to_numpy(drawn)
        _PARAMS[arch, seed] = (np_params, convert.lm_params_to_torch(
            np_params, tcfg.n_layers, "cpu", n_enc_layers=tcfg.n_enc_layers))
    return _PARAMS[arch, seed]


def jparams(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def npf(t):
    """A port tensor as f32 numpy (bf16 through its bits)."""
    a = convert.to_numpy(t)
    if t.dtype == torch.bfloat16:
        a = np.asarray(jnp.asarray(a.view(jnp.bfloat16), jnp.float32))
    return np.asarray(a, np.float32)


def close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    got = npf(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"
    return err / scale


def rms_rel(got, want):
    """||got - want|| / ||want|| over all elements, in f32."""
    got = npf(got) if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def torch_dtype(jax_dtype):
    return {jnp.float32: torch.float32,
            jnp.bfloat16: torch.bfloat16}[jax_dtype.type]


def flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def x(shape, dt, seed):
    """A N(0, 1) array in ``dt``: (reference, port)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ja = jnp.asarray(a, JAX_DT[dt])
    return ja, convert.to_torch(np.asarray(ja), "cpu")


def positions(s, offset=0):
    p = np.broadcast_to(np.arange(s, dtype=np.int32) + offset, (B, s))
    return jnp.asarray(p), torch.from_numpy(np.ascontiguousarray(p))


def batch(cfg, s, seed=7, enc_len=8):
    """The family's batch with ``s`` prefilled positions (a VLM's patches
    among them) as (reference, port) dicts: N(0, 1) f32 patches or frames
    (``enc_len`` of them), uniform token ids."""
    rng = np.random.default_rng(seed)
    text = s - cfg.n_prefix if cfg.family == "vlm" else s
    np_b = {"tokens": rng.integers(0, cfg.vocab, (B, text))}
    if cfg.family == "vlm":
        np_b["patches"] = rng.standard_normal(
            (B, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        np_b["frames"] = rng.standard_normal(
            (B, enc_len, cfg.frontend_dim)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in np_b.items()}
    return jb, {k: torch.from_numpy(v) for k, v in np_b.items()}


def grow(cache, n, seq_len, axis=2):
    """The reference's cache grown by ``n`` slots on ``axis`` (2 in a
    bundle's stacked cache, 1 in one layer's), on the leaves whose axis is
    ``seq_len`` and, in an encoder-decoder cache, only in ``self``
    (``tests/test_decode_consistency_all.py``'s growth)."""
    def one(path, leaf):
        keys = [str(getattr(p, "key", "")) for p in path]
        if ("cross" in keys or leaf.ndim <= axis
                or leaf.shape[axis] != seq_len):
            return leaf
        pad = [(0, 0)] * leaf.ndim
        pad[axis] = (0, n)
        return jnp.pad(leaf, pad)
    return jax.tree_util.tree_map_with_path(one, cache)


def port_cache(cache):
    return convert.cache_to_torch(
        jax.tree_util.tree_map(np.asarray, cache), "cpu")


def clone(tree):
    return tree_map(lambda t: t.clone(), tree)


_JIT = {}


def jbundle(jcfg):
    """The reference bundle of ``jcfg`` with jitted forward / prefill /
    decode_step (one compile per config and shape)."""
    if jcfg not in _JIT:
        jb = jbuild_model(jcfg)
        _JIT[jcfg] = (jb, jax.jit(jb.forward), jax.jit(jb.prefill),
                      jax.jit(jb.decode_step))
    return _JIT[jcfg]


def reference_outputs(jcfg, np_params, jb_in, jnext, s):
    """({name: array}, prefill cache) of the reference bundle in
    ``jcfg.dtype``: the logits of forward, prefill and one decode step
    (from its own prefill cache grown by one slot), and every leaf of both
    caches."""
    jb, fwd, pre, dec = jbundle(jcfg)
    jp = jparams(np_params)
    jf = fwd(jp, jb_in)
    jl, jc = pre(jp, jb_in)
    jd, jc2 = dec(jp, grow(jc, 1, s), jnext, jnp.asarray(s, jnp.int32))
    out = {"forward": jf, "prefill": jl, "decode": jd}
    out.update({f"prefill.{k}": v for k, v in flat(jc).items()})
    out.update({f"decode.{k}": v for k, v in flat(jc2).items()})
    return out, jc


def port_outputs(tb, t_params, tb_in, tnext, s, start_cache):
    """The port bundle's outputs named as :func:`reference_outputs`';
    ``start_cache(prefill cache)`` is the cache decode starts from."""
    with torch.inference_mode():
        tf = tb.forward(t_params, tb_in)
        tl, tc = tb.prefill(t_params, tb_in)
        assert tuple(tl.shape) == (B, 1, tb.cfg.vocab)
        td, tc2 = tb.decode_step(t_params, start_cache(tc), tnext, s)
        assert tuple(td.shape) == (B, tb.cfg.vocab)
    out = {"forward": tf, "prefill": tl, "decode": td}
    out.update({f"prefill.{k}": v for k, v in flat(tc).items()})
    out.update({f"decode.{k}": v for k, v in flat(tc2).items()})
    return out


def check_bundle(arch, dt, s, seed=7, **over):
    """The port bundle of ``arch``'s smoke config against the reference's
    (``forward``, ``prefill``'s logits and every cache leaf, one
    ``decode_step`` and its cache), with the module docstring's gates:
    f32 normwise, decode from the reference's grown prefill cache; bf16 the
    RMS ratio, decode from the port's own prefill cache grown by
    ``launch.serve.grow_cache``.  Returns the ratios."""
    from repro_torch.launch import serve

    jcfg, tcfg = cfgs(arch, dt, **over)
    np_params, t_params = params(arch)
    tb = build_model(tcfg, device="cpu")
    jb_in, tb_in = batch(tcfg, s, seed)
    jnext = jnp.asarray(np.random.default_rng(seed + 1).integers(
        0, tcfg.vocab, (B, 1)), jnp.int32)
    tnext = torch.from_numpy(np.asarray(jnext).astype(np.int64))
    ref, jc = reference_outputs(jcfg, np_params, jb_in, jnext, s)
    if dt == "f32":
        start = lambda _: port_cache(grow(jc, 1, s))       # noqa: E731
    else:
        start = lambda c: serve.grow_cache(clone(c), 1)    # noqa: E731
    port = port_outputs(tb, t_params, tb_in, tnext, s, start)
    assert sorted(port) == sorted(ref)
    for k in port:
        assert port[k].dtype == torch_dtype(ref[k].dtype), k
    if dt == "f32":
        return {k: close(port[k], ref[k], BUNDLE_TOL[dt]) for k in port}
    jcfg32, _ = cfgs(arch, "f32", **over)
    ref32, _ = reference_outputs(jcfg32, np_params, jb_in, jnext, s)
    lo, hi = BUNDLE_TOL[dt]
    ratios = {}
    for k in port:
        own, ours = rms_rel(ref[k], ref32[k]), rms_rel(port[k], ref32[k])
        ratios[k] = ours / own
        assert lo * own <= ours <= hi * own, \
            f"{k}: port bf16 {ours} vs reference bf16 {own} from f32"
    return ratios

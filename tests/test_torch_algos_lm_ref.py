"""dsgd, choco, subgrad-comp, porter-adam and clip21 at LM size against the
JAX package: one round of each with all agents in one process (the CPU),
on the tinyllama smoke config in f32, from the same parameters and
tokens, through ``repro_torch.api.build`` and ``repro.api.build``.

The compressor is the deterministic ``block_top_k`` at 5 %, applied per
model-shard slice of every leaf on both sides (M = 2, the leaves' specs):
the port through ``launch.steps.shard_local_on_one_card``, the reference
through the same cut written here around its own compressor.  That is the
one-card form of the shard-local compressor the model axis runs, so each
round here is the round ``tests/test_torch_tp_algos.py`` holds the grid
against.  The gossip is dense over two agents (the reference's ring
executor needs a mesh); ``comm_backend="ref"`` on both sides; no draw
(the compressor is deterministic and no DP noise).  Gate: every leaf of x
within 1e-5, and the loss; for porter-adam every other buffer within
1e-5 and x within twice the reference's own spread, its x against its
round from parameters one ulp up (as ``tests/test_torch_extensions.py``
holds porter-adam): Adam's first step moves an element by ``eta * v /
(|v| + eps)``, which is near +-eta wherever |v| is near eps, so the f32
sums' last bits move such elements by up to ~1e-4 in either package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import cfgs, jparams, params
from repro import api as japi
from repro.core.compression import make_compressor as jmake_compressor
from repro.data.synthetic import token_batch as jtoken_batch
from repro.models import build_model as jbuild_model
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core.compression import make_compressor
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.nn.module import leaf_specs
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

N, M, SEQ = 2, 2, 32
ALGOS = {"dsgd": {}, "choco": {}, "subgrad-comp": {"clip_mode": "piecewise"},
         "porter-adam": {}, "clip21": {}}
KNOBS = dict(n_agents=N, compressor="block_top_k", frac=0.05,
             comm_backend="ref", eta=3e-2, tau=1.0, topology="ring",
             topology_weights="metropolis")


def _jax_shard_local(specs):
    """The reference's ``block_top_k`` applied to every agent's row of
    every model-shard slice of a stacked leaf (a replicated leaf whole):
    what ``repro.launch.steps.make_shard_local_compress`` computes inside
    ``shard_map`` on a (data, model) mesh, on one device."""
    comp = jmake_compressor("block_top_k", frac=0.05)
    dims = [s.model_dim for s in tree_leaves(specs)]

    def one(leaf, d):
        k = 1 if d is None else M
        width = 1 if d is None else leaf.shape[d + 1] // M
        parts = []
        for m in range(k):
            part = (leaf if d is None else
                    jax.lax.slice_in_dim(leaf, m * width, (m + 1) * width,
                                         axis=d + 1))
            parts.append(jnp.concatenate([comp(None, part[i:i + 1])
                                          for i in range(N)]))
        return parts[0] if d is None else jnp.concatenate(parts, d + 1)

    def compress(key, tree):
        del key
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return treedef.unflatten([one(leaf, d)
                                  for leaf, d in zip(leaves, dims)])

    return compress


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _x(state):
    return state.base.x if hasattr(state, "base") else state.x


@functools.lru_cache(maxsize=None)
def _inputs():
    jcfg, tcfg = cfgs("tinyllama-1.1b", "f32")
    np_params, _ = params("tinyllama-1.1b")
    tokens = np.array(jtoken_batch(jax.random.PRNGKey(3), N, 2, SEQ,
                                   jcfg.vocab))
    specs = leaf_specs(build_model(tcfg, device="cpu"))
    return jcfg, tcfg, np_params, tokens, specs


@pytest.mark.parametrize("algo", list(ALGOS))
def test_one_round_is_the_reference_at_lm_size(algo):
    jcfg, tcfg, np_params, tokens, specs = _inputs()
    jspec = japi.ExperimentSpec(algo=algo, **KNOBS, **ALGOS[algo])
    jalgo = japi.build(jspec, jbuild_model(jcfg).loss,
                       compress_fn=_jax_shard_local(specs))
    jnext, jmet = jax.jit(jalgo.step)(jalgo.init(jparams(np_params)),
                                      {"tokens": jnp.asarray(tokens)},
                                      jax.random.PRNGKey(1))

    tspec = tapi.ExperimentSpec(algo=algo, **KNOBS, **ALGOS[algo])
    talgo = tapi.build(tspec, build_model(tcfg, device="cpu").loss,
                       device="cpu",
                       compress_fn=steps.shard_local_on_one_card(
                           steps.make_shard_local_compress(make_compressor(
                               "block_top_k", frac=0.05)), specs, M))
    assert talgo.gamma == pytest.approx(jalgo.gamma, rel=1e-12)
    state = talgo.init(convert.lm_params_to_torch(np_params, tcfg.n_layers,
                                                  "cpu"))
    new, met = talgo.step(state, {"tokens": torch.from_numpy(tokens)}, None)
    got = _flat(convert.to_numpy(_x(new)))
    want = _flat(jax.device_get(_x(jnext)))
    assert sorted(got) == sorted(want)
    if algo == "porter-adam":
        for name in ("base.v", "base.q_x", "base.m_x", "base.g_prev", "m",
                     "s"):
            a, b = new, jnext
            for part in name.split("."):
                a, b = getattr(a, part), getattr(b, part)
            a, b = _flat(convert.to_numpy(a)), _flat(jax.device_get(b))
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                           err_msg=f"{name} {k}")
        spread = _reference_ulp_spread(jalgo, np_params, tokens, want)
        diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        assert 1e-5 < spread and diff <= 2 * spread, (diff, spread)
    else:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5


def _reference_ulp_spread(jalgo, np_params, tokens, want):
    """max |x - x'| of the reference's round, x' from parameters one ulp
    up: how far its own round moves under one rounding."""
    nudged = jax.tree_util.tree_map(
        lambda v: np.nextafter(v, np.float32(np.inf)), np_params)
    other, _ = jax.jit(jalgo.step)(jalgo.init(jparams(nudged)),
                                   {"tokens": jnp.asarray(tokens)},
                                   jax.random.PRNGKey(1))
    other = _flat(jax.device_get(_x(other)))
    return max(float(np.abs(other[k] - want[k]).max()) for k in want)

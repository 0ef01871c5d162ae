"""The clip and block-top-k kernels on the algorithms' paths, on the CPU.

* The row-stacked clip (``core.clipping.stacked_clip``: every agent's or
  every sample's gradient clipped by its own norm, in one ``clip_planes``
  call over a flat plane) against the reference's
  ``vmap(tree_clip)``, and ``clipped_grad_accumulate`` over stacked and
  shared params against the reference's per-agent call under ``vmap``:
  atol 1e-6, the norms' sums being taken in other orders.
* Which wrappers each algorithm's step reaches, counted by wrapping them
  with ``monkeypatch``: PORTER-GC, DSGD and CHOCO clip once a round
  (``clip_planes``: the fused ``clip`` kernel), the DP algorithms also
  take the sample mean and the noise once (``dp_mean_noise``: the
  ``mean_noise`` kernel), BEER never, and no step calls the passes
  ``clip_sumsq`` / ``clip_scale`` alone (``clip_scale`` with noise, the
  ``scale_noise`` kernel, was the DP perturbation before ``mean_noise``);
  ``block_top_k`` on the dense wire calls ``ops.block_topk`` once a
  compressed leaf, and on the packed wire not at all (the codec selects).
  On the card each call is one kernel launch (``chip_smoke.py`` counts
  them).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.core import clipping as JC
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import clipping as TC
from repro_torch.kernels import ops

torch.set_num_threads(1)

N_AGENTS, BATCH, DIM = 4, 3, 17


def _mlp_grads(seed, n=10):
    """Agent-stacked gradients shaped like the MLP cut to 32 -> 8 -> 10."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (32, 8), "c1": (8,), "w2": (8, 10), "c2": (10,)}
    # rows of very different norms, some below tau
    scale = np.logspace(-3, 2, n).astype(np.float32)
    return {k: (scale.reshape((n,) + (1,) * len(s))
                * rng.standard_normal((n,) + s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("mode", ["smooth", "piecewise", "none"])
def test_stacked_clip_equals_reference_per_agent(mode):
    g = _mlp_grads(7)
    want = jax.vmap(lambda t: JC.tree_clip(t, 0.3, mode))(
        jax.tree_util.tree_map(jnp.asarray, g))
    got = TC.stacked_clip(convert.to_torch(g, "cpu"), 0.3, mode)
    for k in g:
        assert got[k].dtype == torch.float32 and got[k].shape == g[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_stacked_clip_is_tree_clip_of_each_row_and_keeps_dtypes():
    """A mixed f32 / bf16 tree clips on an f32 plane; each row by its own
    norm over all its leaves, each leaf back in its dtype."""
    g = convert.to_torch(_mlp_grads(8, n=4), "cpu")
    g["c1"] = g["c1"].to(torch.bfloat16)
    got = TC.stacked_clip(g, 1.0)
    want = vmap(lambda t: TC.tree_clip(t, 1.0))(g)
    for k in g:
        assert got[k].dtype == g[k].dtype
        torch.testing.assert_close(got[k].float(), want[k].float(),
                                   rtol=0, atol=1e-6 if k != "c1" else 1e-2)


def _logreg_loss_j(params, batch):
    f, l = batch
    logits = f @ params["w"] + params["b"]
    return jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))


def _logreg_loss_t(params, batch):
    f, l = batch
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


@pytest.mark.parametrize("agents", ["stacked", "shared"])
def test_clipped_grad_accumulate_over_agents_equals_reference(agents):
    """PORTER-DP / DSGD (params and batch stacked) and SoteriaFL (shared
    params): one call over all agents' samples against the reference's
    per-agent ``clipped_grad_accumulate`` under ``vmap``."""
    rng = np.random.default_rng(9)
    n, b = 4, 5
    lead = (n,) if agents == "stacked" else ()
    params = {"w": rng.standard_normal(lead + (17,)).astype(np.float32),
              "b": rng.standard_normal(lead).astype(np.float32)}
    batch = ((rng.random((n, b, 17)) < 0.3).astype(np.float32),
             (rng.random((n, b)) < 0.5).astype(np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    fn = lambda p, bb: JC.clipped_grad_accumulate(_logreg_loss_j, p, bb, 0.3)
    if agents == "stacked":
        g_j, loss_j = jax.vmap(fn)(jp, jb)
    else:
        g_j, loss_j = jax.vmap(lambda bb: fn(jp, bb))(jb)
    g_t, loss_t = TC.clipped_grad_accumulate(
        _logreg_loss_t, convert.to_torch(params, "cpu"),
        convert.to_torch(batch, "cpu"), 0.3, agents=agents)
    for k in params:
        assert g_t[k].shape == (n,) + params[k].shape[len(lead):]
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0,
                               atol=1e-6)


def _count_calls(monkeypatch):
    """Wrap the clip and block-top-k wrappers; returns the counter they
    fill."""
    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args, **kw):
            key = name
            if name == "clip_scale" and (kw.get("noise") is not None
                                         or len(args) > 2
                                         and args[2] is not None):
                key = "clip_scale+noise"
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    for name in ("clip_planes", "clip_sumsq", "clip_scale", "dp_mean_noise",
                 "block_topk"):
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    return calls


def _step_once(algo, **over):
    spec = tapi.ExperimentSpec(**dict(
        dict(algo=algo, n_agents=N_AGENTS, topology="ring", compressor="top_k",
             frac=0.25, eta=0.1, tau=0.3, sigma_p=0.05), **over))
    talgo = tapi.build(spec, _logreg_loss_t, device="cpu")
    state = talgo.init({"w": torch.zeros(DIM), "b": torch.zeros(())})
    rng = np.random.default_rng(11)
    batch = (torch.from_numpy((rng.random((N_AGENTS, BATCH, DIM)) < 0.3)
                              .astype(np.float32)),
             torch.from_numpy((rng.random((N_AGENTS, BATCH)) < 0.5)
                              .astype(np.float32)))
    state, met = talgo.step(state, batch, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v).all()) for v in met.values())
    return state


# per algorithm, the calls of one step: (clip_planes, dp_mean_noise);
# clip_sumsq and clip_scale, with noise or without, are called by none
CLIP_CALLS = {"porter-gc": (1, 0), "porter-dp": (1, 1), "dp-sgd": (1, 1),
              "soteriafl": (1, 1), "dsgd": (1, 0), "choco": (1, 0),
              "beer": (0, 0)}


@pytest.mark.parametrize("algo", sorted(CLIP_CALLS))
def test_each_step_clips_through_the_kernel_wrappers(monkeypatch, algo):
    calls = _count_calls(monkeypatch)
    _step_once(algo, **({"tau": None} if algo == "beer" else {}))
    fused, mean_noise = CLIP_CALLS[algo]
    assert calls == collections.Counter(
        {k: v for k, v in (("clip_planes", fused),
                           ("dp_mean_noise", mean_noise)) if v})
    assert calls["clip_scale+noise"] == 0


# the DP steps in each clip mode, and DSGD with DP: (clip_planes,
# dp_mean_noise) a step; piecewise and none clip eagerly, then take the
# same mean-and-noise call
DP_CALLS = {("porter-dp", "smooth"): (1, 1),
            ("porter-dp", "piecewise"): (0, 1), ("porter-dp", "none"): (0, 1),
            ("dsgd-dp", "smooth"): (1, 1), ("dp-sgd", "piecewise"): (0, 1)}


@pytest.mark.parametrize("algo,mode", sorted(DP_CALLS))
def test_every_dp_step_takes_one_mean_noise_call(monkeypatch, algo, mode):
    calls = _count_calls(monkeypatch)
    if algo == "dsgd-dp":
        _step_once("dsgd", dp=True, clip_mode=mode)
    else:
        _step_once(algo, clip_mode=mode)
    fused, mean_noise = DP_CALLS[(algo, mode)]
    assert calls == collections.Counter(
        {k: v for k, v in (("clip_planes", fused),
                           ("dp_mean_noise", mean_noise)) if v})


def test_piecewise_clipping_stays_eager(monkeypatch):
    calls = _count_calls(monkeypatch)
    _step_once("porter-gc", clip_mode="piecewise")
    assert calls == collections.Counter()


# per (algorithm, wire), the block_topk calls of one step: the logreg tree
# has two leaves, PORTER exchanges twice a round and CHOCO once
BLOCK_CALLS = {("porter-gc", "dense"): 4, ("choco", "dense"): 2,
               ("porter-gc", "packed_bits"): 0}


@pytest.mark.parametrize("algo,wire", sorted(BLOCK_CALLS))
def test_block_top_k_reaches_the_kernel_wrapper_on_the_dense_wire(
        monkeypatch, algo, wire):
    calls = _count_calls(monkeypatch)
    over = dict(compressor="block_top_k", frac=0.05, wire=wire)
    if wire == "packed_bits":
        over["gossip_mode"] = "packed"
    _step_once(algo, **over)
    assert calls["block_topk"] == BLOCK_CALLS[(algo, wire)]

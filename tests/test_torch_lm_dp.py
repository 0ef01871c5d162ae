"""PORTER-DP at LM size in the port: the per-sample gradients taken in
chunks of samples, the ``mean_noise`` running sum that makes the chunked
mean the one-shot mean, the chunk the plane's bytes pick, DP steps on an
LM against the JAX reference, and the LM privacy example against the
reference's.

Tolerances, each with its reason:

* bitwise: the chunked running sum against the one-shot mean (the same f32
  additions in the same order onto the same +0.0), and against a numpy
  emulation of the ``mean_noise`` kernel's arithmetic; ``dp_gradient`` and
  ``clipped_grad_accumulate`` at every chunk size against one chunk (each
  sample's gradient and clip are its own, whatever the chunk holds);
* 1e-5 a leaf of ``x``: one PORTER-DP, DP-SGD or SoteriaFL step on
  tinyllama's smoke config from the reference's state, with its token
  batch and its noise injected (the reference sums the clipped samples in
  a scan under ``jax.jit``; the LM's f32 gradients differ from XLA's in
  the last bits), as ``tests/test_torch_lm_train.py`` holds PORTER-GC;
* equal text: the examples' ``model:`` lines (parameter count, sigma_p
  and the accountant's epsilon, printed to the reference's digits).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import cfgs, jparams, params
from repro import api as japi
from repro.data.synthetic import token_batch as jtoken_batch
from repro.models import build_model as jbuild_model
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import clipping as TC
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 8192
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def reference_example():
    """The reference's example at --steps 3, started before the module's
    first test and read by the test that compares the two (it runs while
    the other tests do)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "private_decentralized_lm.py"),
         "--steps", "3"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# the mean_noise running sum
# ---------------------------------------------------------------------------

def _samples(dt, groups=3, b=5, tiles=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((groups, b, tiles, TILE)).astype(F32)
    x[:, :, 0, :64] = -0.0                  # -0.0 sums become +0.0
    t = torch.from_numpy(x)
    if dt == "bf16":
        t = t.to(torch.bfloat16)
    z = torch.from_numpy(rng.standard_normal((groups * tiles, TILE))
                         .astype(F32))
    return t, z


def _chunked(x, z, sigma, chunk):
    groups, b = x.shape[:2]
    acc = None
    for lo in range(0, b, chunk):
        size = min(chunk, b - lo)
        last = lo + size == b
        part = x[:, lo:lo + size].reshape(-1, TILE).contiguous()
        acc = ops.dp_mean_noise(part, groups, size,
                                z if last else None, sigma, acc=acc,
                                finish=last, b_total=b)
    return acc


@pytest.mark.parametrize("chunk", [1, 2, 3, 5])
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_chunked_mean_noise_is_the_one_shot_mean_bitwise(dt, noisy, chunk):
    x, z = _samples(dt)
    groups, b = x.shape[:2]
    z = z if noisy else None
    want = ops.dp_mean_noise(x.reshape(-1, TILE), groups, b, z, 0.3)
    got = _chunked(x, z, 0.3, chunk)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_running_sum_is_the_kernels_arithmetic(chunk):
    """A numpy emulation of ``mean_noise_kernel`` over chunks: every
    chunk adds its samples in order in f32 onto the sum the last one wrote
    (the first onto +0.0) and writes it raw; the last multiplies by
    RN(1 / b_total) and adds RN(sigma * z)."""
    x, z = _samples("f32", groups=2, b=6, tiles=1, seed=4)
    xs = x.numpy()
    groups, b = xs.shape[:2]
    acc = np.zeros((groups, 1, TILE), F32)
    for lo in range(0, b, chunk):
        for s in range(lo, min(lo + chunk, b)):
            acc = (acc + xs[:, s]).astype(F32)
    inv_b = F32(1.0) / F32(b)
    want = (acc * inv_b).astype(F32).reshape(-1, TILE) + (
        F32(0.7) * z.numpy()).astype(F32)
    got = _chunked(x, z, 0.7, chunk).numpy()
    assert np.array_equal(got.view(np.uint32), want.astype(F32).view(
        np.uint32))


@pytest.mark.parametrize("bad", ["noise_not_last", "acc_shape", "b_total"])
def test_mean_noise_chunk_refusals(bad):
    x, z = _samples("f32", groups=1, b=2, tiles=1)
    planes = x.reshape(-1, TILE)
    kw = {"noise_not_last": dict(noise=z, finish=False),
          "acc_shape": dict(acc=torch.zeros(2, TILE)),
          "b_total": dict(b_total=1)}[bad]
    with pytest.raises(ValueError, match="dp_mean_noise"):
        ops.dp_mean_noise(planes, 1, 2, **kw)


# ---------------------------------------------------------------------------
# per-sample gradients in chunks
# ---------------------------------------------------------------------------

def _loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    return torch.mean(torch.logsumexp(logits, -1)
                      - logits.gather(-1, batch["y"][..., None])[..., 0])


def _problem(agents, n=3, b=5, d=9, k=4, seed=2):
    g = torch.Generator().manual_seed(seed)
    p = {"w": torch.randn(d, k, generator=g), "b": torch.randn(k, generator=g)}
    if agents == "stacked":
        p = tree_map(lambda a: a.unsqueeze(0).expand((n,) + a.shape)
                     + 0.1 * torch.randn((n,) + a.shape, generator=g), p)
    lead = () if agents is None else (n,)
    batch = {"x": 3 * torch.randn(lead + (b, d), generator=g),
             "y": torch.randint(0, k, lead + (b,), generator=g)}
    return p, batch


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("mode", ["smooth", "piecewise", "none"])
@pytest.mark.parametrize("agents", [None, "stacked", "shared"])
@pytest.mark.parametrize("fn", ["dp_gradient", "clipped_grad_accumulate"])
def test_chunked_per_sample_mean_is_the_unchunked_one_bitwise(fn, agents,
                                                              mode, chunk):
    p, batch = _problem(agents)
    b = batch["y"].shape[-1]

    def run(c):
        if fn == "dp_gradient":
            return TC.dp_gradient(_loss, p, batch, 0.3, 0.2,
                                  gen=torch.Generator().manual_seed(5),
                                  mode=mode, agents=agents, sample_chunk=c)
        return TC.clipped_grad_accumulate(_loss, p, batch, 0.3, mode,
                                          agents, sample_chunk=c)
    ops.reset_launches()
    want, want_loss = run(b)
    got, got_loss = run(chunk)
    assert torch.equal(got_loss, want_loss)
    for a, w in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))


def test_default_chunk_is_the_whole_batch_for_a_small_plane(monkeypatch):
    """Without ``sample_chunk`` a small plane takes one chunk (one clip,
    one mean), and a budget below one sample's plane takes one sample a
    chunk; both give the same bits."""
    p, batch = _problem("stacked")
    calls = []
    real = ops.dp_mean_noise

    def spy(planes, groups, b, *a, **kw):
        calls.append(b)
        return real(planes, groups, b, *a, **kw)
    monkeypatch.setattr(ops, "dp_mean_noise", spy)
    want, _ = TC.clipped_grad_accumulate(_loss, p, batch, 0.3,
                                         agents="stacked")
    assert calls == [5]
    calls.clear()
    monkeypatch.setattr(TC, "SAMPLE_PLANE_BYTES", 1)
    got, _ = TC.clipped_grad_accumulate(_loss, p, batch, 0.3,
                                        agents="stacked")
    assert calls == [1] * 5
    for a, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("name,groups,params,b,want", [
    # tinyllama-1.1b at its full width, 2 of 22 layers, 4 agents: the
    # per-sample plane is 4 x 26,754 tiles, 3.51 GB in f32
    ("full-width cell", 4, 219_162_624, 4, 1),
    # the Section-5.2 MLP (d = 50,890: 7 tiles), 10 agents, batch 8
    ("mlp porter-dp", 10, 50_890, 8, 8),
    # the fleet: 4,096 agents of logreg d = 124 (1 tile), batch 4
    ("fleet porter-dp", 4096, 124, 4, 4),
])
def test_sample_chunk_from_the_planes_bytes(name, groups, params, b, want):
    tiles = -(-params // TILE)
    assert TC.sample_chunk(groups, tiles, b) == want
    if want == 1:
        assert groups * tiles * TILE * 4 <= TC.SAMPLE_PLANE_BYTES
        assert 2 * groups * tiles * TILE * 4 > TC.SAMPLE_PLANE_BYTES
    else:
        assert groups * b * tiles * TILE * 4 <= TC.SAMPLE_PLANE_BYTES
    assert TC.sample_chunk(groups, tiles, b, budget=1) == 1


# ---------------------------------------------------------------------------
# DP steps on tinyllama's smoke config against the reference
# ---------------------------------------------------------------------------

N, B, SEQ = 2, 2, 16


def _normal_per_leaf(key, tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten([np.asarray(jax.random.normal(
        k, np.shape(leaf), jnp.float32)) for k, leaf in zip(keys, leaves)])


def _stacked_normal(agent_keys, tree):
    per_agent = [_normal_per_leaf(k, tree) for k in agent_keys]
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *per_agent)


def reference_noise(algo, key, tree):
    """The N(0, 1) draws of the reference's step from round key ``key``:
    ``porter_step`` hands the second of four splits to the agents,
    SoteriaFL the first of two, DP-SGD the key itself; each agent splits
    its key once per gradient leaf."""
    if algo == "porter-dp":
        return _stacked_normal(jax.random.split(jax.random.split(key, 4)[1],
                                                N), tree)
    if algo == "soteriafl":
        return _stacked_normal(jax.random.split(jax.random.split(key)[0], N),
                               tree)
    return _normal_per_leaf(key, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("algo", ["porter-dp", "dp-sgd", "soteriafl"])
def test_dp_step_on_the_lm_from_the_reference_state(algo, monkeypatch):
    """One step from the reference's state (after a warm step), the
    reference's token batch and noise injected, the port's per-sample
    gradients one sample a chunk."""
    jcfg, tcfg = cfgs("tinyllama-1.1b", "f32")
    np_params, _ = params("tinyllama-1.1b")
    knobs = dict(algo=algo, n_agents=N, compressor="top_k", frac=1.0,
                 comm_backend="ref", eta=3e-2, tau=1.0, sigma_p=0.05)
    jalgo = japi.build(japi.ExperimentSpec(**knobs),
                       jbuild_model(jcfg).loss)
    jstep = jax.jit(jalgo.step)
    jstate = jalgo.init(jparams(np_params))
    tokens = jtoken_batch(jax.random.PRNGKey(3), N, B, SEQ, jcfg.vocab)
    jstate, _ = jstep(jstate, {"tokens": tokens}, jax.random.PRNGKey(1))
    tokens2 = jtoken_batch(jax.random.PRNGKey(4), N, B, SEQ, jcfg.vocab)
    key = jax.random.PRNGKey(2)
    jnext, jmet = jstep(jstate, {"tokens": tokens2}, key)

    monkeypatch.setattr(TC, "SAMPLE_PLANE_BYTES", 1)    # c = 1
    talgo = tapi.build(tapi.ExperimentSpec(**knobs),
                       build_model(tcfg, device="cpu").loss, device="cpu")
    state = convert.state_to_torch(jax.device_get(jstate), "cpu")
    noise = convert.to_torch(reference_noise(algo, key, np_params), "cpu")
    calls = []
    real = ops.dp_mean_noise

    def spy(planes, groups, b, *a, **kw):
        calls.append((b, kw.get("finish", True)))
        return real(planes, groups, b, *a, **kw)
    monkeypatch.setattr(ops, "dp_mean_noise", spy)
    batch = {"tokens": torch.from_numpy(np.array(tokens2))}
    new, met = talgo.step(state, batch, None, noise=noise)
    samples = N * B if algo == "dp-sgd" else B
    assert calls == [(1, False)] * (samples - 1) + [(1, True)]
    got, want = _flat(convert.to_numpy(new.x)), _flat(jax.device_get(jnext.x))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_example_model_line_is_the_references(reference_example):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "private_decentralized_lm_torch.py"),
         "--steps", "3", "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=300)
    assert port.returncode == 0, port.stderr[-3000:]
    out, err = reference_example.communicate(timeout=300)
    assert reference_example.returncode == 0, err[-3000:]

    def model_line(text):
        return [line for line in text.splitlines()
                if line.startswith("model:")]
    assert model_line(port.stdout) == model_line(out) != []
    losses = [float(v) for v in re.findall(r"loss (\S+)", port.stdout)
              if v[0].isdigit() or v[0] == "-"]
    assert losses and np.all(np.isfinite(losses))

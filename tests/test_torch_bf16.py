"""bf16 EF planes on the port against the JAX reference, on the CPU.

Four layers, each against its reference counterpart:

* the stochastic-rounding cast: ``ref.sr_cast_ref`` and ``ops.sr_cast`` /
  ``ops.sr_cast_leaf`` against ``repro.kernels.ops.sr_cast`` (interpret
  mode) / ``sr_cast_leaf`` on the reference's own random words, bitwise;
* the fused updates with bf16 operands and ``out_dtype``:
  ``ef_track_ref`` / ``ef_step_ref`` / ``ef_gossip_ref`` against
  ``repro.kernels.ops.ef_*`` in interpret mode;
* one comm round (``track_update`` / ``step_update`` / ``gossip_apply``)
  under bf16 with the reference's SR words injected: the port's 'kernel'
  backend against the reference's pallas backend (interpret mode), 'ref'
  against 'ref';
* whole runs through ``api.build`` + ``run_chunked``: the state layout,
  the f32-vs-bf16 loss gap of every registered algorithm (the reference's
  gate, ``tests/test_plane_dtype.py``), and f32 runs unchanged.

Exactness: the surrogate / mirror outputs (``q + c``, ``m + wc``: one add)
and every SR cast are bitwise equal to the reference.  The third output
(``y + gamma*(m - q) ...``) is not: XLA on the CPU contracts
``gamma*(m - q) + y`` into one fused multiply-add, while the port keeps the
reference kernel's op-by-op rounding (what its CUDA kernel matches bitwise
on the card).  It is held at atol 1e-6 in f32, and within one unit of the
last bf16 place where it is rounded to bf16.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm_round as JCR
from repro.core import compression as JCMP
from repro.core import gossip as JG
from repro.core import mixing as JM
from repro.kernels import ops as jops
from repro.kernels import sr_cast as jsr
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import PorterState
from repro_torch.core import comm_round as TCR
from repro_torch.core import compression as TCMP
from repro_torch.core import gossip as TG
from repro_torch.core import mixing as TM
from repro_torch.data import a9a_like, minibatch_source, shard_to_agents
from repro_torch.kernels import flatten as TFL
from repro_torch.kernels import ops, ref
from repro_torch.launch.runtime import run_chunked
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

GAMMA, ETA, SCALE = 0.37, 0.05, 0.5
N = 4
BF16 = jnp.bfloat16


def _bits_u16(a):
    """A bf16 array or tensor as its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return convert.to_numpy(a)
    return np.asarray(a).view(np.uint16)


def _assert_same(got, want, exact):
    """Bitwise when ``exact``; else atol 1e-6 (f32) or one bf16 unit."""
    if want.dtype == BF16:
        assert got.dtype == torch.bfloat16
        g, w = _bits_u16(got).astype(np.int64), _bits_u16(want)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w.astype(np.int64)).max() <= 1
        return
    assert got.dtype == torch.float32
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def _to_int32(bits):
    return torch.from_numpy(np.asarray(bits).view(np.int32).copy())


# ---------------------------------------------------------------------------
# the stochastic-rounding cast
# ---------------------------------------------------------------------------

_EDGE_VALUES = np.array(
    [0.0, -0.0, 1.0, -1.0, 1.5, -1.5, 3.0e38, -3.0e38, 1.0e-40, -1.0e-40,
     0.1, -0.1, 65504.0, -2.5e-3], np.float32)
_EDGE_WORDS = np.array([0, 0xFFFF, 0xFFFFFFFF, 0x8000, 0x7FFF, 0x12345678,
                        0xFFFF0000, 0x0001], np.uint32)


def test_sr_cast_ref_bit_patterns():
    """Every value against every word: negatives, signed zeros, values
    whose low 16 bits are 0 (exact in bf16: they never move), and words
    whose int32 view is negative."""
    x = np.repeat(_EDGE_VALUES, len(_EDGE_WORDS))
    w = np.tile(_EDGE_WORDS, len(_EDGE_VALUES))
    want = ((x.view(np.uint32) + (w & 0xFFFF)) >> 16).astype(np.uint16)
    got = ref.sr_cast_ref(torch.from_numpy(x), _to_int32(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits_u16(got), want)
    np.testing.assert_array_equal(
        _bits_u16(got), _bits_u16(jsr.sr_cast_ref(jnp.asarray(x),
                                                  jnp.asarray(w))))
    exact = (x.view(np.uint32) & 0xFFFF) == 0
    np.testing.assert_array_equal(_bits_u16(got)[exact],
                                  (x.view(np.uint32)[exact] >> 16))


@pytest.mark.parametrize("d", [1, 123, 8192, 9001])
def test_sr_cast_plane_matches_reference(d):
    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    key = jax.random.PRNGKey(d)
    want = jops.sr_cast(jnp.asarray(x), key, interpret=True)
    tiles = -(-d // TFL.TILE)
    bits = jax.random.bits(key, (tiles, TFL.TILE), jnp.uint32)
    plane = torch.zeros(tiles * TFL.TILE)
    plane[:d] = torch.from_numpy(x)
    got = ops.sr_cast(plane.reshape(tiles, TFL.TILE), _to_int32(bits))
    np.testing.assert_array_equal(_bits_u16(got.reshape(-1)[:d]),
                                  _bits_u16(want))


def _leaf_bits(key, shape):
    """The words ``repro.kernels.ops.sr_cast_leaf`` draws for one leaf."""
    if len(shape) == 0:
        return jax.random.bits(key, shape, jnp.uint32)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(shape[0]))
    return jax.vmap(lambda k: jax.random.bits(k, shape[1:], jnp.uint32))(
        keys)


@pytest.mark.parametrize("shape", [(), (7,), (4, 5), (4, 3, 9)])
def test_sr_cast_leaf_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jops.sr_cast_leaf(jnp.asarray(x), key)
    got = ops.sr_cast_leaf(torch.from_numpy(x),
                           _to_int32(_leaf_bits(key, shape)))
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits_u16(got), _bits_u16(want))


# ---------------------------------------------------------------------------
# the fused updates: bf16 operands, out_dtype
# ---------------------------------------------------------------------------

# kernel -> (plain version, reference wrapper, operand count, scalars)
EF = {"track": (ref.ef_track_ref, jops.ef_track, 7, (GAMMA,)),
      "step": (ref.ef_step_ref, jops.ef_step, 6, (GAMMA, ETA)),
      "gossip": (ref.ef_gossip_ref, jops.ef_gossip, 5, (GAMMA, SCALE))}


@pytest.mark.parametrize("d", [123, 9001])
@pytest.mark.parametrize("out", ["f32", "state"])
@pytest.mark.parametrize("kernel", sorted(EF))
def test_ef_bf16_variants_match_reference(kernel, out, d):
    """The mixes the engine issues: ef_track all bf16; ef_step / ef_gossip
    with an f32 x / y (slot 2) beside bf16 EF operands."""
    plain, jfn, k, scalars = EF[kernel]
    rng = np.random.default_rng(d + k)
    arrs = [jnp.asarray(rng.standard_normal(d).astype(np.float32))
            for _ in range(k)]
    arrs = [a if (i == 2 and kernel != "track") else a.astype(BF16)
            for i, a in enumerate(arrs)]
    out_dtype = jnp.float32 if out == "f32" else None
    want = jfn(*arrs, *scalars, interpret=True, out_dtype=out_dtype)
    got = plain(*(convert.to_torch(a, "cpu") for a in arrs), *scalars,
                out_dtype=torch.float32 if out == "f32" else None)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, exact=i < 2)
    # the ops wrapper takes the same plain path on CPU tensors
    planes = [convert.to_torch(a, "cpu") for a in arrs]
    via_ops = getattr(ops, f"ef_{kernel}")(
        *planes, *scalars, out_dtype=torch.float32 if out == "f32" else None)
    assert all(torch.equal(a, b) for a, b in zip(via_ops, got))


@pytest.mark.parametrize("d", [1, 9001])
def test_ef_gossip_f32_matches_reference(d):
    rng = np.random.default_rng(d)
    arrs = [rng.standard_normal(d).astype(np.float32) for _ in range(5)]
    for scale in (1.0, SCALE):
        want = jops.ef_gossip(*arrs, GAMMA, scale, interpret=True)
        got = ref.ef_gossip_ref(*map(torch.from_numpy, arrs), GAMMA, scale)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, exact=i < 2)


def test_ops_reject_mixes_the_engine_never_issues():
    f = [torch.zeros(2, TFL.TILE) for _ in range(7)]
    b = [t.to(torch.bfloat16) for t in f]
    ops.reset_launches()
    ops.ef_track(*b, GAMMA, out_dtype=torch.float32)
    ops.ef_step(*b[:2], f[2], *b[3:6], GAMMA, ETA)
    ops.ef_gossip(*b[:2], f[2], *b[3:5], GAMMA)
    for bad in (lambda: ops.ef_track(*b[:2], f[2], *b[3:], GAMMA),
                lambda: ops.ef_step(*b[:6], GAMMA, ETA),
                lambda: ops.ef_gossip(*f[:2], b[2], *f[3:5], GAMMA),
                lambda: ops.ef_track(*f, GAMMA, out_dtype=torch.bfloat16),
                lambda: ops.sr_cast(b[0], torch.zeros(2, TFL.TILE,
                                                      dtype=torch.int32)),
                lambda: ops.sr_cast(f[0], torch.zeros(2, TFL.TILE))):
        with pytest.raises(TypeError):
            bad()
    with pytest.raises(ValueError, match="plane"):
        ops.sr_cast(torch.zeros(5), torch.zeros(5, dtype=torch.int32))
    assert set(ops.LAUNCHES.values()) == {0}


def test_bf16_tree_packs_to_a_bf16_plane():
    tree = {"a": torch.randn(N, 3, 5).to(torch.bfloat16),
            "b": torch.randn(N, 7).to(torch.bfloat16)}
    spec = TFL.flat_spec(tree)
    plane = TFL.to_planes(tree, spec)
    assert spec.plane_dtype == torch.bfloat16 == plane.dtype
    back = TFL.from_planes(plane, spec)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    mixed = dict(tree, b=tree["b"].float())
    assert TFL.flat_spec(mixed).plane_dtype == torch.float32


# ---------------------------------------------------------------------------
# one comm round under bf16, the reference's SR words injected
# ---------------------------------------------------------------------------

SHAPES = {"b": (N, 7), "w": (N, 300, 30)}   # 9,007 per agent: two tiles


def _tree(rng, dtype):
    return {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
            .astype(dtype) for k, s in SHAPES.items()}


def _engines(backend):
    jtop, ttop = JM.make_topology("ring", N), TM.make_topology("ring", N)
    jeng = JCR.CommRound(JCMP.top_k(0.25), JG.make_mixer(jtop, "dense"),
                         backend="pallas" if backend == "kernel" else "ref",
                         interpret=True, plane_dtype=BF16)
    teng = TCR.CommRound(TCMP.top_k(0.25), TG.make_mixer(ttop, "dense"),
                         backend=backend, plane_dtype=torch.bfloat16)
    return jeng, teng


def _reference_words(backend, sr_key, outs):
    """The SR words the reference draws from ``sr_key`` for outputs ``outs``
    (kernel order q, m, y), as the port's per-output int32 planes."""
    keys = jax.random.split(sr_key, 3)
    words = []
    for key, tree in zip(keys, outs):
        if tree_leaves(tree)[0].dtype != BF16:
            words.append(None)
            continue
        ttree = convert.to_torch(tree, "cpu")
        spec = TFL.flat_spec(ttree)
        if backend == "kernel":   # one draw over each padded plane
            words.append(_to_int32(jax.random.bits(key, spec.plane_shape,
                                                   jnp.uint32)))
            continue
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        lkeys = jax.random.split(key, len(leaves))
        per_leaf = treedef.unflatten([_to_int32(_leaf_bits(k, leaf.shape))
                                      for k, leaf in zip(lkeys, leaves)])
        words.append(TFL.to_planes(per_leaf, TFL.flat_spec(per_leaf)))
    return tuple(words)


def _round(method, backend, seed=0):
    rng = np.random.default_rng(seed)
    bf = {n: _tree(rng, BF16) for n in ("q", "m", "v", "g", "gp", "c", "wc")}
    x = _tree(rng, jnp.float32)
    sr_key = jax.random.PRNGKey(seed + 7)
    jeng, teng = _engines(backend)
    t = lambda tree: convert.to_torch(tree, "cpu")
    if method == "track_update":
        args = [bf[n] for n in ("c", "wc", "v", "q", "m", "g", "gp")]
        want = jeng.track_update(*args, GAMMA, sr_key=sr_key)
        words = _reference_words(backend, sr_key, (bf["q"], bf["m"], bf["v"]))
        got = teng.track_update(*map(t, args), GAMMA, sr_bits=words)
    elif method == "step_update":
        args = [bf["c"], bf["wc"], x, bf["q"], bf["m"], bf["v"]]
        want = jeng.step_update(*args, GAMMA, ETA, sr_key=sr_key)
        words = _reference_words(backend, sr_key, (bf["q"], bf["m"], x))
        got = teng.step_update(*map(t, args), GAMMA, ETA, sr_bits=words)
    else:
        key = jax.random.PRNGKey(seed + 9)
        want = jeng.gossip_apply(key, x, bf["q"], bf["m"], GAMMA, SCALE)
        _, k_sr = jax.random.split(key)
        words = _reference_words(backend, k_sr, (bf["q"], bf["m"], x))
        got = teng.gossip_apply(None, t(x), t(bf["q"]), t(bf["m"]), GAMMA,
                                SCALE, sr_bits=words)
    return got, want


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("method", ["track_update", "step_update",
                                    "gossip_apply"])
def test_bf16_round_matches_reference(method, backend):
    ops.reset_launches()
    got, want = _round(method, backend)
    # returned (y', q', m'): q' and m' bitwise, y' as the module says
    for i, (g_tree, w_tree) in enumerate(zip(got, want)):
        for k in w_tree:
            _assert_same(g_tree[k], w_tree[k], exact=i > 0)
    assert set(ops.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# whole runs through the entry points
# ---------------------------------------------------------------------------

def _loss(params, batch):
    f, l = batch
    f, l = torch.atleast_2d(f), torch.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


def _run(algo, steps=8, chunk=4, seed=0, **over):
    kw = dict(algo=algo, n_agents=N, topology="ring",
              topology_weights="metropolis", compressor="top_k", frac=0.25,
              eta=0.1)
    if tapi.algorithm_info(algo).dp:
        kw.update(tau=5.0, sigma_p=0.01)
    kw.update(over)
    talgo = tapi.build(tapi.ExperimentSpec(**kw), _loss, device="cpu")
    x, y = a9a_like(400, 33, seed=0)
    xs, ys = shard_to_agents(x, y, N)
    source = minibatch_source(xs, ys, batch=4, device="cpu")
    state = talgo.init({"w": torch.zeros(33), "b": torch.zeros(())})
    mets = []
    state, _ = run_chunked(talgo, source, state, seed, steps, chunk=chunk,
                           on_chunk=lambda t0, t1, s, m: mets.append(m))
    return state, {k: torch.cat([m[k] for m in mets]) for k in mets[0]}


# algorithm -> (params field, EF fields) under plane_dtype='bf16'
LAYOUTS = {"porter-gc": ("x", ("v", "q_x", "q_v", "g_prev", "m_x", "m_v")),
           "porter-dp": ("x", ("v", "q_x", "q_v", "g_prev", "m_x", "m_v")),
           "beer": ("x", ("v", "q_x", "q_v", "g_prev", "m_x", "m_v")),
           "choco": ("x", ("q", "m")),
           "soteriafl": ("x", ("h",))}


def _nbytes(state, fields):
    return sum(leaf.numel() * leaf.element_size()
               for f in fields for leaf in tree_leaves(getattr(state, f)))


@pytest.mark.parametrize("algo", sorted(LAYOUTS))
def test_bf16_state_layout(algo):
    """f32 master params, bf16 EF buffers, and half their f32 bytes."""
    params, ef = LAYOUTS[algo]
    s16, _ = _run(algo, steps=4, plane_dtype="bf16")
    s32, _ = _run(algo, steps=4)
    assert all(leaf.dtype == torch.float32
               for leaf in tree_leaves(getattr(s16, params)))
    for field in ef:
        assert all(leaf.dtype == torch.bfloat16
                   for leaf in tree_leaves(getattr(s16, field))), field
    assert 2 * _nbytes(s16, ef) == _nbytes(s32, ef)


@pytest.mark.parametrize("algo", tapi.list_algorithms())
def test_f32_vs_bf16_final_loss(algo):
    """Every registered algorithm trains with bf16 planes to its f32 twin's
    loss within 0.02 (``tests/test_plane_dtype.py``'s gate)."""
    _, m32 = _run(algo)
    _, m16 = _run(algo, plane_dtype="bf16")
    l32, l16 = float(m32["loss"][-1]), float(m16["loss"][-1])
    assert np.isfinite(l32) and np.isfinite(l16)
    assert abs(l32 - l16) <= 0.02, (algo, l32, l16)
    assert np.isfinite(float(m16["wire_bytes"][-1]))


@pytest.mark.parametrize("over", [dict(algo="porter-gc"),
                                  dict(algo="porter-dp", overlap=True,
                                       compressor="random_k"),
                                  dict(algo="choco", compressor="random_k")])
def test_bf16_kernel_backend_equals_ref_backend_exactly(over):
    """Both backends read the one plane of SR words each output draws, so
    bf16 runs are bitwise equal across them (and overlap draws as the
    sequential order does)."""
    over = dict(over, plane_dtype="bf16")
    (sk, mk), (sr, mr) = (_run(comm_backend=b, **over)
                          for b in ("kernel", "ref"))
    for a, b in zip(tree_leaves(tuple(sk)[:-1]), tree_leaves(tuple(sr)[:-1])):
        assert torch.equal(a, b)
    assert all(torch.equal(mk[k], mr[k]) for k in mk)
    if over.get("overlap"):
        seq, _ = _run(**dict(over, overlap=False, comm_backend="kernel"))
        for a, b in zip(tree_leaves(tuple(sk)[:-1]),
                        tree_leaves(tuple(seq)[:-1])):
            assert torch.equal(a, b)


def test_f32_engine_draws_no_sr_words():
    eng = tapi.build(tapi.ExperimentSpec(algo="porter-gc", n_agents=N),
                     _loss, device="cpu").engine
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    f32 = {"w": torch.zeros(N, 9)}
    assert eng.sr_draw(gen, (f32, f32, f32)) is None
    assert torch.equal(gen.get_state(), before)
    words = eng.sr_draw(gen, ({"w": torch.zeros(N, 9, dtype=torch.bfloat16)},
                              f32, f32))
    assert words[1] is None and words[2] is None
    assert words[0].dtype == torch.int32 and words[0].shape == (N, TFL.TILE)


# sha256 (first 16 hex digits) of every state buffer after 6 f32 rounds,
# recorded on the f32-only engine (commit 0987497): f32 runs keep their
# generator draws and their values bit for bit.  The clipped runs were
# recorded again when the smooth clip took the sumsq kernel's fixed-order
# norm and the correctly rounded factor tau / (tau + norm) (it was
# ``RN(RN(1 / (tau + norm)) * tau)``); with the old clip arithmetic put
# back, the new code gives the old digests, so the draws did not move.
# The PORTER-GC run was recorded once more when the clip factor took the
# correctly rounded square root and the fused kernel's fixed order over a
# row's partials (it was ``torch.sqrt``, one ulp low on some sums on the
# CPU, of ``partials.sum(1)``); with those put back it gives
# 7d4423f9e3128fcd again.  The test ids keep the first recording's digests
# (``F32_IDS``), so that each case keeps its name across the re-recordings.
F32_FINGERPRINTS = [
    (dict(algo="porter-dp", compressor="random_k", comm_backend="kernel"),
     "ca2a60ef384d754d"),
    (dict(algo="porter-dp", compressor="random_k", comm_backend="ref"),
     "ca2a60ef384d754d"),
    (dict(algo="porter-gc", compressor="random_k", overlap=True,
          comm_backend="kernel"), "5feafcc7e54534c1"),
    (dict(algo="beer", comm_backend="ref", tau=None), "414bb89473d06459"),
]
F32_IDS = ["over0-8869bc3847da4c8c", "over1-8869bc3847da4c8c",
           "over2-55b90c24700e74c6", "over3-414bb89473d06459"]


@pytest.mark.parametrize("over,digest", F32_FINGERPRINTS, ids=F32_IDS)
def test_f32_runs_are_unchanged(over, digest):
    kw = dict(n_agents=N, topology="ring", compressor="top_k", frac=0.25,
              eta=0.1, tau=1.0, sigma_p=0.05)
    kw.update(over)
    talgo = tapi.build(tapi.ExperimentSpec(**kw), _loss, device="cpu")
    x, y = a9a_like(num=400, dim=33, seed=0)
    xs, ys = shard_to_agents(x, y, N)
    source = minibatch_source(xs, ys, batch=4, device="cpu")
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
        0.1 * rng.standard_normal(33).astype(np.float32)),
        "b": torch.zeros(())}
    state, _ = run_chunked(talgo, source, talgo.init(params), 7, 6, chunk=3)
    assert isinstance(state, PorterState)
    h = hashlib.sha256()
    for leaf in tree_leaves(tuple(state)[:-1]):
        h.update(leaf.numpy().tobytes())
    assert h.hexdigest()[:16] == digest

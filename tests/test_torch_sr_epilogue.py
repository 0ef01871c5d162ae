"""The stochastic-rounding epilogue of the fused ef updates, on the CPU.

``ops.ef_track`` / ``ef_step`` / ``ef_gossip`` with ``sr_bits=`` round each
bf16 output with its int32 words in the kernel's epilogue on the card; on
CPU tensors the wrappers run the plain composite (the f32 outputs, then
``ref.sr_cast_ref`` on each output given words).  Held here:

* against the JAX reference's composite, ``repro.kernels.ops.ef_*(...,
  interpret=True, out_dtype=f32)`` then ``repro.kernels.sr_cast.sr_cast(...,
  interpret=True)`` on the same words (drawn with numpy over the whole u32
  range, bridged u32 <-> int32), at the MLP's plane and at odd leaf sizes.
  The q and m outputs (one add each) are bitwise.  The third output is
  not, as in ``tests/test_torch_bf16.py``: XLA on the CPU contracts
  ``gamma*(m - q) + y`` into a fused multiply-add, the port keeps the
  reference kernel's op-by-op rounding.  So ef_track's rounded v is held
  bitwise to the reference's ``sr_cast`` of the port's own f32 v, and
  within one bf16 unit of the reference's composite; the f32 x / y of
  ef_step / ef_gossip is held at atol 1e-6, as there;
* against the port's own composite, ``ops.ef_*(out_dtype=f32)`` then
  ``ops.sr_cast``, bitwise on every output, on edge values too (signed
  zeros, low 16 bits at or above 0x8000, magnitudes near the largest
  finite f32);
* the wrappers' refusals (words beside ``out_dtype``, for an f32 slot, of
  the wrong dtype, shape or layout);
* the engine's plane path: bf16 rounds call ``ops.sr_cast`` 0 times and
  hand the words to the ef wrappers instead (counted with ``monkeypatch``).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sr_cast as jsr
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.data import a9a_like, minibatch_source, shard_to_agents
from repro_torch.kernels import flatten as TFL
from repro_torch.kernels import ops
from repro_torch.launch.runtime import run_chunked

torch.set_num_threads(1)

GAMMA, ETA, SCALE = 0.37, 0.05, 0.5
BF16 = jnp.bfloat16
MLP_PLANE = (70, TFL.TILE)          # the Section-5.2 MLP's 10 x 7 tiles

# kernel -> (reference wrapper, operand count, scalars, slot 2 bf16)
EF = {"ef_track": (jops.ef_track, 7, (GAMMA,), True),
      "ef_step": (jops.ef_step, 6, (GAMMA, ETA), False),
      "ef_gossip": (jops.ef_gossip, 5, (GAMMA, SCALE), False)}


def _bits(a):
    """bf16 as uint16 bit patterns, f32 as uint32 ones (numpy)."""
    if isinstance(a, torch.Tensor):
        a = convert.to_numpy(a)
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a.view(np.uint16)


def _operands(kernel, shape, seed):
    """Operands as the engine issues them: bf16 EF operands, slot 2 bf16
    for ef_track and f32 otherwise; and the u32 words of each bf16 output
    (over the whole range: the high bits are set and must be ignored)."""
    _, k, _, y_bf16 = EF[kernel]
    rng = np.random.default_rng(seed)
    arrs = []
    for i in range(k):
        a = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        arrs.append(a if i == 2 and not y_bf16 else a.astype(BF16))
    tiles = -(-int(np.prod(shape)) // TFL.TILE)
    words = [rng.integers(0, 2 ** 32, (tiles, TFL.TILE), dtype=np.uint64)
             .astype(np.uint32) if i < 2 or y_bf16 else None
             for i in range(3)]
    return arrs, words


def _port_words(words, shape):
    """The u32 plane words as the port's int32 operands of ``shape``."""
    n = int(np.prod(shape))
    return tuple(None if w is None else torch.from_numpy(
        w.reshape(-1)[:n].view(np.int32).reshape(shape).copy())
        for w in words)


def _reference_sr(x, w, shape):
    """The reference's SR kernel (interpret mode) over ``x`` padded to the
    words' plane, cut back to ``shape``."""
    n = int(np.prod(shape))
    flat = jnp.zeros(w.size, jnp.float32).at[:n].set(
        jnp.asarray(x, jnp.float32).reshape(-1))
    out = jsr.sr_cast(flat.reshape(w.shape), jnp.asarray(w), interpret=True)
    return out.reshape(-1)[:n].reshape(shape)


@pytest.mark.parametrize("shape", [MLP_PLANE, (1,), (123,), (4, 2301)],
                         ids=["mlp-plane", "d1", "d123", "d9204"])
@pytest.mark.parametrize("kernel", sorted(EF))
def test_sr_epilogue_equals_reference_composite(kernel, shape):
    jfn, _, scalars, y_bf16 = EF[kernel]
    arrs, words = _operands(kernel, shape, seed=len(kernel) + shape[-1])
    want = jfn(*arrs, *scalars, interpret=True, out_dtype=jnp.float32)
    planes = [convert.to_torch(a, "cpu") for a in arrs]
    got = getattr(ops, kernel)(*planes, *scalars,
                               sr_bits=_port_words(words, shape))
    f32 = getattr(ops, kernel)(*planes, *scalars, out_dtype=torch.float32)
    for slot in (0, 1):
        assert got[slot].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits(got[slot]),
            _bits(_reference_sr(want[slot], words[slot], shape)))
    if y_bf16:
        assert got[2].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits(got[2]), _bits(_reference_sr(f32[2].numpy(), words[2],
                                               shape)))
        ref_v = _bits(_reference_sr(want[2], words[2], shape))
        assert np.abs(_bits(got[2]).astype(np.int64)
                      - ref_v.astype(np.int64)).max() <= 1
    else:
        assert got[2].dtype == torch.float32
        np.testing.assert_array_equal(_bits(got[2]), _bits(f32[2]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-6)


# (q, c) pairs whose f32 sum q' = q + c (taken to bf16 first) is an edge of
# the rounding: signed zeros, low 16 bits 0x8000, 0xC000 and 0xFF00 (half
# way and above), magnitudes whose rounding up passes the largest finite
# bf16 (0x7F7F8000 + r may carry into the exponent: inf), subnormals
_EDGE_QC = np.array([(0.0, 0.0), (-0.0, -0.0), (0.0, -0.0),
                     (1.0, 2.0 ** -8), (-1.0, -2.0 ** -8),
                     (1.0, 1.5 * 2.0 ** -8), (1.0, 255 * 2.0 ** -15),
                     (3.3895314e38, 2.0 ** 119), (-3.3895314e38, -2.0 ** 119),
                     (2.0 ** -130, 2.0 ** -133), (0.1, -0.3)], np.float32)


def _edge_operands(kernel, shape, seed):
    """q = m and c = wc from the edge pairs; the other operands Gaussian."""
    _, k, _, y_bf16 = EF[kernel]
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    pairs = np.resize(_EDGE_QC, (n, 2))
    q, c = (torch.from_numpy(pairs[:, i].copy()).reshape(shape)
            for i in (0, 1))
    planes = []
    for i in range(k):
        t = (q if i in (0, 1) else c if i in (3, 4) else torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)))
        planes.append(t if i == 2 and not y_bf16 else t.to(torch.bfloat16))
    return planes


@pytest.mark.parametrize("edge", [False, True], ids=["gauss", "edge"])
@pytest.mark.parametrize("shape", [MLP_PLANE, (3, 17)],
                         ids=["mlp-plane", "d51"])
@pytest.mark.parametrize("kernel", sorted(EF))
def test_sr_epilogue_equals_f32_outputs_then_sr_cast(kernel, shape, edge):
    """Bitwise the kernel's own two-step form, ``out_dtype=f32`` then
    ``sr_cast`` on each output given words: what the card checks the fused
    epilogue against."""
    _, _, scalars, y_bf16 = EF[kernel]
    if edge:
        if kernel == "ef_gossip":   # at scale 1, so that q' = q + c
            scalars = (GAMMA, 1.0)
        planes = _edge_operands(kernel, shape, seed=3)
        _, words = _operands(kernel, shape, seed=4)
    else:
        arrs, words = _operands(kernel, shape, seed=5)
        planes = [convert.to_torch(a, "cpu") for a in arrs]
    bits = _port_words(words, shape)
    got = getattr(ops, kernel)(*planes, *scalars, sr_bits=bits)
    f32 = getattr(ops, kernel)(*planes, *scalars, out_dtype=torch.float32)
    for slot, (g, f, w) in enumerate(zip(got, f32, bits)):
        want = f if w is None else ops.sr_cast_leaf(f, w)
        np.testing.assert_array_equal(_bits(g), _bits(want))
    if edge:   # the edges are there: signed zeros, the low halves, huge
        q2 = _bits(f32[0]).reshape(-1)
        assert {0x00000000, 0x80000000} <= set(q2.tolist())
        assert {0x8000, 0xC000, 0xFF00} <= set((q2 & 0xFFFF).tolist())
        assert 0x7F7F8000 in set(q2.tolist())


def test_wrappers_refuse_bad_sr_bits():
    shape = (2, TFL.TILE)
    b = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(7)]
    f = [torch.zeros(shape) for _ in range(7)]
    w = torch.zeros(shape, dtype=torch.int32)
    ops.reset_launches()
    ops.ef_track(*b, GAMMA, sr_bits=(w, w, w))
    ops.ef_step(*b[:2], f[2], *b[3:6], GAMMA, ETA, sr_bits=(w, w, None))
    ops.ef_gossip(*b[:2], f[2], *b[3:5], GAMMA, sr_bits=[w, w, None])
    type_errors = (
        # words beside out_dtype
        lambda: ops.ef_track(*b, GAMMA, out_dtype=torch.float32,
                             sr_bits=(w, w, w)),
        # words for an f32-bound slot, and none for a bf16 one
        lambda: ops.ef_step(*b[:2], f[2], *b[3:6], GAMMA, ETA,
                            sr_bits=(w, w, w)),
        lambda: ops.ef_track(*b, GAMMA, sr_bits=(w, w, None)),
        lambda: ops.ef_gossip(*b[:2], f[2], *b[3:5], GAMMA,
                              sr_bits=(w, None, None)),
        lambda: ops.ef_track(*f, GAMMA, sr_bits=(w, w, w)),
        # words of the wrong dtype
        lambda: ops.ef_track(*b, GAMMA, sr_bits=(w, w, w.float())),
        lambda: ops.ef_step(*b[:2], f[2], *b[3:6], GAMMA, ETA,
                            sr_bits=(w.long(), w, None)),
    )
    for bad in type_errors:
        with pytest.raises(TypeError):
            bad()
    value_errors = (
        # the wrong shape, layout or count
        lambda: ops.ef_track(*b, GAMMA, sr_bits=(w, w, w[:1])),
        lambda: ops.ef_track(*b, GAMMA, sr_bits=(w, w, w.reshape(-1))),
        lambda: ops.ef_track(*b, GAMMA,
                             sr_bits=(w, w, w.t().contiguous().t())),
        lambda: ops.ef_track(*b, GAMMA, sr_bits=(w, w)),
        lambda: ops.ef_track(*f, GAMMA, sr_bits=(None, None, None)),
    )
    for bad in value_errors:
        with pytest.raises(ValueError):
            bad()
    # the CPU path launches nothing and rounds nothing on a card
    assert set(ops.LAUNCHES.values()) == {0}


N = 4


def _loss(params, batch):
    feats, labels = batch
    feats, labels = torch.atleast_2d(feats), torch.atleast_1d(labels)
    logits = feats @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * labels - 1) * logits)))


def _count(monkeypatch):
    """Count ``ops.sr_cast`` / ``sr_cast_leaf`` calls and the ef calls,
    by whether they were given words."""
    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args, **kw):
            words = kw.get("sr_bits")
            calls[name if words is None else f"{name}+sr"] += 1
            if words is not None:
                calls["rounded outputs"] += sum(x is not None for x in words)
            return fn(*args, **kw)
        return wrapper

    for name in ("sr_cast", "sr_cast_leaf", "ef_track", "ef_step",
                 "ef_gossip"):
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    return calls


@pytest.mark.parametrize("algo,steps,per_round", [
    ("porter-gc", 4, {"ef_track+sr": 1, "ef_step+sr": 1,
                      "rounded outputs": 5}),
    ("choco", 4, {"ef_gossip+sr": 1, "rounded outputs": 2})])
def test_plane_path_rounds_in_the_ef_wrappers(monkeypatch, algo, steps,
                                              per_round):
    """bf16 planes on the kernel backend: every round hands its SR words
    to the ef wrappers (5 rounded outputs a PORTER round, 2 a CHOCO
    round) and calls ``ops.sr_cast`` 0 times."""
    calls = _count(monkeypatch)
    spec = tapi.ExperimentSpec(algo=algo, n_agents=N, topology="ring",
                               topology_weights="metropolis",
                               compressor="top_k", frac=0.25, eta=0.1,
                               plane_dtype="bf16", comm_backend="kernel")
    talgo = tapi.build(spec, _loss, device="cpu")
    x, y = a9a_like(400, 33, seed=0)
    xs, ys = shard_to_agents(x, y, N)
    source = minibatch_source(xs, ys, batch=4, device="cpu")
    state = talgo.init({"w": torch.zeros(33), "b": torch.zeros(())})
    ops.reset_launches()
    run_chunked(talgo, source, state, 0, steps, chunk=2)
    assert dict(calls) == {k: steps * v for k, v in per_round.items()}
    assert set(ops.LAUNCHES.values()) == {0}

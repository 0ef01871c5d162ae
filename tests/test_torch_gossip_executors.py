"""The ring, plain packed and ring codec gossip executors of the port (all
agents on one card) against the reference's ``shard_map`` executors, one
agent per device on a mesh of 4 (and 2) fake CPU devices in a subprocess.

The reference ships buffers with ``ppermute`` (ring) or an all-gather
(packed); the port rolls the agent axis or reads every agent's buffers in
place.  Each agent computes the same arithmetic in both, so:

* bitwise: every executor against the reference compiled with XLA's
  backend optimisation off (``--xla_backend_optimization_level=0``), which
  runs its program op by op, as the reference's eager ``shard_map`` does
  (the ring: ``w_self x`` + ``w_prev prev`` + ``w_next next`` in that
  order; a static ring's weights weakly typed, so bf16 leaves mix in bf16;
  a schedule's or a push's weights f32 arrays, so they mix in f32); the
  push-sum weight; the packed executor's top-k pairs and sender-ordered
  scatter-add (ties to the lower index); the top-k codec's ``c`` and
  ``wc``;
* the reference as the engine compiles it (optimisation on): XLA on the
  CPU contracts ``out + b * copy`` into fused multiply-adds
  (``fma(w_next, next, fma(w_self, x, w_prev * prev))``), so the ring's
  outputs lie within 2^-22 (f32) or 2^-7 (bf16) of the sum of the terms'
  magnitudes ``S = sum_j |w_ij| |x_j|``; the packed scatter-add stays
  bitwise;
* atol 1e-5: the qsgd codec (its scale sums the squares in XLA's order, a
  few ulps from the port's, as ``tests/test_torch_codec.py`` holds it);
* exact: the wire bytes (integer arithmetic).
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import gossip as JG
from repro.core import mixing as JM
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import gossip as TG
from repro_torch.core import mixing as TM
from repro_torch.core import wire_formats as TWF
from repro_torch.kernels import ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# leaves that pad separately: 77 -> 1 window, 2100 -> 2, a scalar -> 1
SHAPES = {"a": (7, 11), "b": (2100,), "c": ()}
SCHEDULE = ["ring/metropolis", "ring/lazy"]
CASES = [(n, dt, w) for n in (4, 2) for dt in ("f32", "bf16")
         for w in ("static", "sched")]
TOL = {"f32": 2.0 ** -22, "bf16": 2.0 ** -7}

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + sys.argv[3])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.api import ExperimentSpec, build_engine
    from repro.core import gossip as G, mixing as M, wire_formats as WF

    data = dict(np.load(sys.argv[1]))
    full = sys.argv[3] != ""          # optimisation off: every case
    out = {}
    key = jax.random.PRNGKey(7)
    topk = WF.make_wire_format("top_k", frac=0.25)
    qsgd = WF.make_wire_format("qsgd", levels=7)
    for n in ((4, 2) if full else (4,)):
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

        def put(v):
            return jax.device_put(v, NamedSharding(
                mesh, P("data", *([None] * (v.ndim - 1)))))
        ws = {"static": M.make_topology("ring", n).w,
              "sched": M.rotating_schedule(["ring/metropolis", "ring/lazy"],
                                           n).ws}
        wvec = put(jnp.asarray(data[f"w{n}"]))
        for dt in ("f32", "bf16"):
            tree = {k: put(jnp.asarray(data[f"{k}{n}"], jnp.dtype(
                "float32" if dt == "f32" else "bfloat16"))) for k in "abc"}
            for wname, w in ws.items():
                tag = f"{n}_{dt}_{wname}"
                t = None if wname == "static" else 1
                ring = G.make_ring_mixer(w, mesh)
                res, out[f"pushw_{tag}"] = jax.jit(ring.push)(tree, wvec, t)
                calls = {"ring": jax.jit(ring)(tree, t), "push": res,
                         "packed": jax.jit(G.make_packed_mixer(
                             w, mesh, 0.25))(tree, t)}
                for name, res in calls.items():
                    for k in "abc":
                        out[f"{name}_{tag}_{k}"] = np.asarray(res[k])
                codecs = [("topk", topk)] + (
                    [("qsgd", qsgd)] if dt == "f32" and full else [])
                for cname, codec in codecs:
                    mix = G.make_ring_codec_mixer(w, mesh, codec)
                    c, wc = jax.jit(mix.exchange)(key, tree, t)
                    for k in "abc":
                        out[f"{cname}_{tag}_c_{k}"] = np.asarray(c[k])
                        out[f"{cname}_{tag}_wc_{k}"] = np.asarray(wc[k])
                    if cname == "topk":
                        _, wc, cw, wcw = jax.jit(mix.exchange_ps)(
                            key, tree, wvec, t)
                        out[f"ps_{tag}_cw"] = np.asarray(cw)
                        out[f"ps_{tag}_wcw"] = np.asarray(wcw)
                        for k in "abc":
                            out[f"ps_{tag}_wc_{k}"] = np.asarray(wc[k])
        # the qsgd uniforms: leaf j of agent i packs with
        # fold_in(split(key, L)[j], i), in its window shape
        keys = jax.random.split(key, 3)
        out[f"noise_{n}"] = np.concatenate([np.asarray(jax.random.uniform(
            jax.random.fold_in(keys[j], i),
            (-(-int(np.prod(data[f"{k}{n}"].shape[1:])) // 2048), 2048)))
            for j, k in enumerate("abc") for i in range(n)])
    if full:
        mesh = Mesh(np.array(jax.devices()), ("data",))
        tree = {k: jnp.asarray(data[f"{k}4"]) for k in "abc"}
        for mode, wire, comp in (("dense", "dense", "top_k"),
                                 ("ring", "dense", "top_k"),
                                 ("packed", "dense", "top_k"),
                                 ("ring", "packed_bits", "top_k"),
                                 ("packed", "packed_bits", "top_k"),
                                 ("ring", "packed_bits", "qsgd"),
                                 ("packed", "packed_bits", "qsgd")):
            for pd in (None, "bf16"):
                eng = build_engine(ExperimentSpec(
                    n_agents=4, compressor=comp, frac=0.25,
                    gossip_mode=mode, wire=wire, plane_dtype=pd,
                    compressor_kwargs=({"levels": 7} if comp == "qsgd"
                                       else {})), mesh=mesh)
                out[f"bytes_{mode}_{wire}_{comp}_{pd}"] = np.array(
                    [eng.wire_bytes(tree, push_sum=ps) for ps in (0, 1)]
                    + [eng.wire_bytes_model(tree, push_sum=ps)
                       for ps in (0, 1)]
                    + [eng.wire_bytes(2100, 4), eng.wire_bytes(2100, 2)])
    np.savez(sys.argv[2], **out)
    print("reference-executors-ok")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs: ``("o0", ...)`` compiled op by op for every
    case, ``("o2", ...)`` as the engine compiles it at n = 4; both
    subprocesses run at once."""
    tmp = tmp_path_factory.mktemp("executors")
    rng = np.random.default_rng(3)
    data = {}
    for n in (4, 2):
        for k, s in SHAPES.items():
            data[f"{k}{n}"] = rng.standard_normal((n,) + s).astype(np.float32)
        data[f"w{n}"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / f"{name}.npz"), flags], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, flags in (("o0", "--xla_backend_optimization_level=0"),
                            ("o2", ""))}
    out = {"in": data}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert "reference-executors-ok" in stdout, stderr[-3000:]
        out[name] = dict(np.load(tmp / f"{name}.npz"))
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _f32(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 2:               # bf16 bits, however they came
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _port_inputs(reference, n, dt):
    data = reference["in"]
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    tree = {k: torch.from_numpy(data[f"{k}{n}"]).to(tdt) for k in "abc"}
    return tree, torch.from_numpy(data[f"w{n}"])


def _w(n, wname):
    if wname == "static":
        return TM.make_topology("ring", n).w, None
    return TM.rotating_schedule(SCHEDULE, n).ws, 1


def _assert_bitwise(got, want, what):
    got = convert.to_numpy(got)
    assert np.array_equal(_bits(got), _bits(want)), (
        what, float(np.abs(_f32(got) - _f32(want)).max()))


def _assert_contracted(got, want, x, w_t, dt, what):
    """Within TOL[dt] of the sum of the terms' magnitudes: ``x`` the mixed
    operand (agent-stacked), ``w_t`` the round's matrix."""
    n = x.shape[0]
    xs = _f32(convert.to_numpy(x)).reshape(n, -1).astype(np.float64)
    terms = (np.abs(w_t) @ np.abs(xs)).reshape(want.shape)
    err = np.abs(_f32(convert.to_numpy(got)) - _f32(want))
    assert np.all(err <= TOL[dt] * terms), (what, float(err.max()))


@pytest.mark.parametrize("n,dt,wname", CASES)
def test_ring_mixer_and_push_are_the_reference(reference, n, dt, wname):
    tree, wvec = _port_inputs(reference, n, dt)
    w, t = _w(n, wname)
    ring = TG.make_ring_mixer(w)
    mixed = ring(tree, t)
    shipped = ring.shipped_nbytes
    pushed, w_m = ring.push(tree, wvec, t)
    ref0 = reference["o0"]
    tag = f"{n}_{dt}_{wname}"
    for k in "abc":
        assert mixed[k].dtype == pushed[k].dtype == tree[k].dtype
        _assert_bitwise(mixed[k], ref0[f"ring_{tag}_{k}"], ("ring", k))
        _assert_bitwise(pushed[k], ref0[f"push_{tag}_{k}"], ("push", k))
    _assert_bitwise(w_m, ref0[f"pushw_{tag}"], "push weight")
    if n == 4:
        ref2 = reference["o2"]
        w_t = w if t is None else w[t]
        for k in "abc":
            _assert_contracted(mixed[k], ref2[f"ring_{tag}_{k}"], tree[k],
                               w_t, dt, ("ring", k))
            _assert_contracted(pushed[k], ref2[f"push_{tag}_{k}"], tree[k],
                               w_t, "f32" if dt == "f32" else "bf16",
                               ("push", k))
        _assert_contracted(w_m, ref2[f"pushw_{tag}"], wvec, w_t, "f32",
                           "push weight")
    # one agent's leaves (and a push's f32 weight) to each live
    # neighbour: one shift at n = 2
    live = 1 if n == 2 else 2
    per_agent = sum(v[0].numel() * v.element_size() for v in tree.values())
    assert shipped == live * per_agent
    assert ring.shipped_nbytes == live * (per_agent + 4)


@pytest.mark.parametrize("n,dt,wname", CASES)
def test_packed_mixer_is_the_reference(reference, n, dt, wname):
    tree, _ = _port_inputs(reference, n, dt)
    w, t = _w(n, wname)
    mix = TG.make_packed_mixer(w, 0.25)
    got = mix(tree, t)
    tag = f"{n}_{dt}_{wname}"
    for k in "abc":
        _assert_bitwise(got[k], reference["o0"][f"packed_{tag}_{k}"], k)
        if n == 4:
            _assert_bitwise(got[k], reference["o2"][f"packed_{tag}_{k}"], k)
    k_b = TWF.topk_keep(0.25)
    windows = 1 + 2 + 1
    value = 4 if dt == "f32" else 2
    assert mix.shipped_nbytes == n * windows * k_b * (value + 4)


def test_packed_mixer_is_the_dense_mix_of_k_sparse_windows():
    """On an increment that is k-sparse in every window (the top-k
    compressors' output) the packed executor loses nothing: its scatter-add
    is ``W @ c`` to f32 rounding (every sender's pairs are all its
    nonzeros).  On a window of equal magnitudes it keeps the first k_b
    entries (``jax.lax.top_k``'s ties to the lower index)."""
    from repro_torch.core.compression import block_top_k
    top = TM.make_topology("erdos_renyi", 5, weights="best_constant",
                           p=0.8, seed=1)
    g = torch.Generator().manual_seed(2)
    rows = torch.randn(5, 6144, generator=g)
    c = block_top_k(0.05)(None, rows)
    got = TG.make_packed_mixer(top.w, 0.05)({"x": c})["x"]
    want = TG.make_dense_mixer(top.w)({"x": c})["x"]
    assert float((got - want).abs().max()) <= 1e-6
    ties = torch.full((2, 2048), 0.5)
    ties[:, 1::2] = -0.5
    kept = TG.make_packed_mixer(np.eye(2), 0.05)({"x": ties})["x"]
    k_b = TWF.topk_keep(0.05)
    assert torch.equal(kept[:, :k_b], ties[:, :k_b])
    assert not kept[:, k_b:].any()


@pytest.mark.parametrize("n,dt,wname", CASES)
def test_ring_codec_exchange_is_the_reference(reference, n, dt, wname):
    tree, wvec = _port_inputs(reference, n, dt)
    w, t = _w(n, wname)
    tag = f"{n}_{dt}_{wname}"
    mix = TG.make_ring_codec_mixer(w, TWF.make_wire_format("top_k",
                                                           frac=0.25))
    c, wc = mix.exchange(None, tree, t)
    c2, wc2, cw, wcw = mix.exchange_ps(None, tree, wvec, t)
    ref0 = reference["o0"]
    for k in "abc":
        assert c[k].dtype == wc[k].dtype == tree[k].dtype
        _assert_bitwise(c[k], ref0[f"topk_{tag}_c_{k}"], ("c", k))
        _assert_bitwise(wc[k], ref0[f"topk_{tag}_wc_{k}"], ("wc", k))
        _assert_bitwise(wc2[k], ref0[f"ps_{tag}_wc_{k}"], ("ps wc", k))
        assert torch.equal(c2[k], c[k])
    _assert_bitwise(cw, ref0[f"ps_{tag}_cw"], "cw")
    assert torch.equal(cw, wvec)
    _assert_bitwise(wcw, ref0[f"ps_{tag}_wcw"], "wcw")
    if n == 4:
        w_t = w if t is None else w[t]
        for k in "abc":
            _assert_contracted(wc[k], reference["o2"][f"topk_{tag}_wc_{k}"],
                               c[k], w_t, dt, ("wc", k))


@pytest.mark.parametrize("n,wname", [(4, "static"), (4, "sched"),
                                     (2, "static"), (2, "sched")])
def test_ring_codec_qsgd_with_the_reference_uniforms(reference, n, wname):
    tree, _ = _port_inputs(reference, n, "f32")
    w, t = _w(n, wname)
    tag = f"{n}_f32_{wname}"
    ref0 = reference["o0"]
    mix = TG.make_ring_codec_mixer(w, TWF.make_wire_format("qsgd", levels=7))
    c, wc = mix.exchange(None, tree, t,
                         noise=torch.from_numpy(ref0[f"noise_{n}"]))
    for k in "abc":
        np.testing.assert_allclose(c[k].numpy(), ref0[f"qsgd_{tag}_c_{k}"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(wc[k].numpy(), ref0[f"qsgd_{tag}_wc_{k}"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("codec", ["topk", "qsgd"])
def test_one_unpack_rolled_is_the_unpack_of_rolled_buffers(codec):
    """The port unpacks every agent's buffers once and rolls the rows; the
    reference unpacks the shifted buffers on the receiver.  The unpacks
    work window by window, so the two agree bitwise, on windows whose
    top-k indices repeat too (summed in slot order)."""
    n, nb = 4, 3
    g = torch.Generator().manual_seed(6)
    rows = torch.randn(n * nb, 2048, generator=g)
    if codec == "topk":
        fmt = TWF.make_wire_format("top_k", frac=0.05)
        vals, idx = fmt.pack(rows)
        idx = idx.clone()
        idx[:, 1::2] = idx[:, ::2]              # every index twice
        bufs = (vals, idx)
    else:
        fmt = TWF.make_wire_format("qsgd", levels=7)
        bufs = fmt.pack(rows, torch.rand(rows.shape, generator=g))
    once = fmt.unpack(*bufs).reshape(n, nb, 2048)
    for shift in (1, -1):
        rolled = tuple(b.reshape((n, nb) + b.shape[1:]).roll(shift, 0)
                       .reshape(b.shape) for b in bufs)
        again = fmt.unpack(*rolled).reshape(n, nb, 2048)
        assert torch.equal(once.roll(shift, 0).view(torch.int32),
                           again.view(torch.int32))
    if codec == "topk":
        # a repeated index sums its values in slot order
        v = vals[0].float()
        want = torch.zeros(2048)
        for s in range(v.shape[0]):
            want[idx[0, s].long()] += v[s]
        assert torch.equal(ref.topk_unpack_ref(vals[:1], idx[:1])[0], want)


BYTES_CASES = [(mode, wire, comp, pd)
               for mode, wire, comp in (("dense", "dense", "top_k"),
                                        ("ring", "dense", "top_k"),
                                        ("packed", "dense", "top_k"),
                                        ("ring", "packed_bits", "top_k"),
                                        ("packed", "packed_bits", "top_k"),
                                        ("ring", "packed_bits", "qsgd"),
                                        ("packed", "packed_bits", "qsgd"))
               for pd in (None, "bf16")]


@pytest.mark.parametrize("mode,wire,comp,pd", BYTES_CASES)
def test_wire_bytes_are_the_reference(reference, mode, wire, comp, pd):
    spec = tapi.ExperimentSpec(
        n_agents=4, compressor=comp, frac=0.25, gossip_mode=mode, wire=wire,
        plane_dtype=pd,
        compressor_kwargs={"levels": 7} if comp == "qsgd" else {})
    eng = tapi.build_engine(spec)
    tree = convert.to_torch({k: reference["in"][f"{k}4"] for k in "abc"},
                            "cpu")
    got = np.array([eng.wire_bytes(tree, push_sum=ps) for ps in (0, 1)]
                   + [eng.wire_bytes_model(tree, push_sum=ps)
                      for ps in (0, 1)]
                   + [eng.wire_bytes(2100, 4), eng.wire_bytes(2100, 2)])
    np.testing.assert_array_equal(
        got, reference["o0"][f"bytes_{mode}_{wire}_{comp}_{pd}"])


@pytest.mark.parametrize("kind", ["erdos_renyi", "rotate"])
def test_a_schedule_off_the_ring_raises_the_reference_message(kind):
    kw = (dict(p=0.8, period=4) if kind == "erdos_renyi"
          else dict(kinds=["ring", "star"]))
    jsched = JM.make_schedule(kind, 6, **kw)
    tsched = TM.make_schedule(kind, 6, **kw)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(ValueError) as want:
        JG.make_mixer(jsched, "ring", mesh=mesh)
    with pytest.raises(ValueError) as got:
        TG.make_mixer(tsched, "ring")
    assert str(got.value) == str(want.value)
    assert tsched.is_banded_ring() == jsched.is_banded_ring() is False
    ring = TM.rotating_schedule(SCHEDULE, 6)
    assert ring.is_banded_ring() and TM.make_topology("ring",
                                                      6).is_banded_ring()
    with pytest.raises(ValueError, match="not a circulant ring band"):
        TG.make_mixer(TM.make_topology("complete", 6), "ring")

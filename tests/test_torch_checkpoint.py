"""Checkpoint and resume in the port (``repro_torch.launch.checkpoint``,
``repro_torch.launch.train``) against the JAX reference on the CPU.

Tolerances, each with its reason:

* exact: every round trip (the port's states of all eleven algorithms, f32
  and bf16 planes, save -> restore -> one more step), restores across the
  two packages (a checkpoint written by one restores bitwise into the
  other; the npz key sets and the manifests are equal), the mid-period
  resumes against the port's own uninterrupted runs, the refusals'
  messages, and ``resolve_privacy``'s results;
* atol 1e-5: the resumed runs against the reference's uninterrupted run
  (the gradients and ``W_t @ c`` are f32 sums in another order).
"""

import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.launch import checkpoint as JC
from repro.launch import train as JT
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.launch import checkpoint as TC
from repro_torch.launch import train as TT
from repro_torch.launch.runtime import round_generators, run_chunked
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N, STEPS = 4, 3
ALGOS = sorted(japi.list_algorithms())


def _loss_t(p, batch):
    return torch.mean((batch[0] @ p["w"] + p["b"]) ** 2)


def _loss_j(p, batch):
    return jnp.mean((batch[0] @ p["w"] + p["b"]) ** 2)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": np.zeros(3, np.float32)}


def _spec_kw(name, **over):
    kw = dict(algo=name, n_agents=N, topology="ring", compressor="top_k",
              frac=0.3, eta=0.05, tau=5.0, sigma_p=0.01)
    if name == "subgrad-comp":
        kw["gamma"] = 0.3
    kw.update(over)
    return kw


def _batch(t, n=N):
    rng = np.random.default_rng(100 + t)
    return (rng.standard_normal((n, 2, 5)).astype(np.float32),)


def _port_run(name, steps=STEPS, **over):
    algo = tapi.build(tapi.ExperimentSpec(**_spec_kw(name, **over)), _loss_t,
                      device="cpu")
    state = algo.init(convert.to_torch(_params(), "cpu"))
    for t in range(steps):
        _, gen = round_generators(0, t, "cpu")
        state, _ = algo.step(state, convert.to_torch(_batch(t), "cpu"), gen)
    return algo, state


def _tensors(state):
    """Every tensor of a state, a nested ``base`` included (not the int
    round counters)."""
    return [leaf for leaf in tree_leaves(tuple(state))
            if isinstance(leaf, torch.Tensor)]


def _assert_bitwise(a, b):
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def _step_of(state):
    return state.base.step if hasattr(state, "base") else state.step


# ---------------------------------------------------------------------------
# round trips: every algorithm, f32 and bf16 planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane", [None, "bf16"])
@pytest.mark.parametrize("name", ALGOS)
def test_roundtrip_is_bitwise_and_resumes_bitwise(tmp_path, name, plane):
    algo, state = _port_run(name, plane_dtype=plane)
    path = TC.save_state(str(tmp_path), state)
    assert path.endswith("step_00000003")
    assert TC.latest_step(str(tmp_path)) == STEPS
    restored = TC.restore_state(str(tmp_path), like=algo.init(
        convert.to_torch(_params(1), "cpu")))
    assert type(restored) is algo.state_cls
    _assert_bitwise(restored, state)
    assert type(_step_of(restored)) is int and _step_of(restored) == STEPS
    if plane == "bf16" and name in ("porter-gc", "choco", "soteriafl"):
        assert any(t.dtype == torch.bfloat16 for t in _tensors(restored))
    # one more round from each: the same bits
    _, gen_a = round_generators(0, STEPS, "cpu")
    _, gen_b = round_generators(0, STEPS, "cpu")
    batch = convert.to_torch(_batch(STEPS), "cpu")
    s1, _ = algo.step(state, batch, gen_a)
    s2, _ = algo.step(restored, batch, gen_b)
    _assert_bitwise(s1, s2)


def test_latest_step_labels_and_manifest_extra(tmp_path):
    algo, state = _port_run("porter-gc")
    for step in (1, 20, 5):
        TC.save_state(str(tmp_path), state, step=step,
                      extra={"rounds_executed": step, "sigma_p": 0.25})
    assert TC.latest_step(str(tmp_path)) == 20
    assert TC.latest_step(str(tmp_path / "none")) is None
    restored = TC.restore_state(str(tmp_path), like=state, step=5)
    assert restored.step == 5 and type(restored.step) is int
    man = TC.read_manifest(str(tmp_path))
    assert man["step"] == 20 and man["extra"] == {"rounds_executed": 20,
                                                  "sigma_p": 0.25}
    assert TC.read_manifest(str(tmp_path), step=1)["step"] == 1
    assert man["state_cls"] == "PorterState"
    assert man["buffers"]["step"] == {"_root": {"shape": [],
                                                "dtype": "int32"}}
    assert man["buffers"]["x"]["w"] == {"shape": [N, 5, 3],
                                        "dtype": "float32"}


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

CROSS = [("porter-gc", None), ("porter-gc", "bf16"), ("porter-adam", None),
         ("clip21", "bf16"), ("dp-csgp", None), ("soteriafl", "bf16"),
         ("choco", None)]


@functools.lru_cache(maxsize=None)
def _ref_run(name, plane, steps=STEPS):
    algo = japi.build(japi.ExperimentSpec(**_spec_kw(name,
                                                     plane_dtype=plane)),
                      _loss_j)
    state = algo.init(jax.tree_util.tree_map(jnp.asarray, _params()))
    step = jax.jit(algo.step)
    for t in range(steps):
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, _batch(t)),
                        jax.random.PRNGKey(t))
    return algo, state


def _npz(d, name):
    with np.load(d / f"{name}.npz") as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name,plane", CROSS)
def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path, name,
                                                             plane):
    _, ref_state = _ref_run(name, plane)
    JC.save_state(str(tmp_path), ref_state, extra={"rounds_executed": 3})
    talgo = tapi.build(tapi.ExperimentSpec(**_spec_kw(name,
                                                      plane_dtype=plane)),
                       _loss_t, device="cpu")
    restored = TC.restore_state(str(tmp_path), like=talgo.init(
        convert.to_torch(_params(), "cpu")))
    _assert_bitwise(restored, convert.state_to_torch(ref_state, "cpu"))
    assert type(_step_of(restored)) is int and _step_of(restored) == STEPS
    assert TC.read_manifest(str(tmp_path)) == JC.read_manifest(str(tmp_path))


@pytest.mark.parametrize("name,plane", CROSS)
def test_port_checkpoint_restores_into_the_reference_bitwise(tmp_path, name,
                                                             plane):
    _, state = _port_run(name, plane_dtype=plane)
    TC.save_state(str(tmp_path), state)
    ralgo = japi.build(japi.ExperimentSpec(**_spec_kw(name,
                                                      plane_dtype=plane)),
                       _loss_j)
    restored = JC.restore_state(str(tmp_path), like=ralgo.init(
        jax.tree_util.tree_map(jnp.asarray, _params())))
    assert type(restored).__name__ == type(state).__name__
    want = convert.state_to_numpy(state)
    for got, exp in zip(jax.tree_util.tree_leaves(restored),
                        jax.tree_util.tree_leaves(want)):
        got = np.asarray(got)
        if got.dtype.name == "bfloat16":
            got = got.view(np.uint16)
        assert got.dtype == exp.dtype and np.array_equal(got, exp)


@pytest.mark.parametrize("name,plane", CROSS)
def test_both_packages_write_the_same_keys_arrays_and_manifest(tmp_path,
                                                               name, plane):
    """The same state, written once by each package: equal npz key sets
    (in the same order), equal arrays and equal manifests as dicts."""
    _, ref_state = _ref_run(name, plane)
    extra = {"rounds_executed": 3, "topology_schedule": None}
    JC.save_state(str(tmp_path / "ref"), ref_state, extra=extra)
    TC.save_state(str(tmp_path / "port"),
                  convert.state_to_torch(ref_state, "cpu"), extra=extra)
    d_ref = tmp_path / "ref" / "step_00000003"
    d_port = tmp_path / "port" / "step_00000003"
    want = json.loads((d_ref / "manifest.json").read_text())
    assert json.loads((d_port / "manifest.json").read_text()) == want
    for field in want["fields"]:
        a, b = _npz(d_ref, field), _npz(d_port, field)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    if name in ("porter-adam", "clip21"):
        assert ".step" in want["buffers"]["base"]
        assert ".x/w" in want["buffers"]["base"]
    if name == "dp-csgp":
        assert want["buffers"]["xw"] == {"_root": {"shape": [N],
                                                   "dtype": "float32"}}


def test_restore_puts_each_leaf_on_the_like_device_and_dtype(tmp_path):
    _, state = _port_run("porter-gc", plane_dtype="bf16")
    TC.save_state(str(tmp_path), state)
    like = state._replace(x={k: v.to(torch.float64)
                             for k, v in state.x.items()})
    restored = TC.restore_state(str(tmp_path), like=like)
    assert all(v.dtype == torch.float64 for v in restored.x.values())
    assert restored.v["w"].dtype == torch.bfloat16
    assert all(t.device.type == "cpu" for t in _tensors(restored))


# ---------------------------------------------------------------------------
# mid-period resumes (tests/test_topology_schedule.py,
# tests/test_push_sum.py, ported)
# ---------------------------------------------------------------------------

D, M = 16, 32


def _logreg_t(params, batch):
    f, l = batch
    f, l = torch.atleast_2d(f), torch.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


def _logreg_j(params, batch):
    f, l = batch
    f, l = jnp.atleast_2d(f), jnp.atleast_1d(l)
    logits = f @ params["w"] + params["b"]
    return jnp.mean(jnp.log1p(jnp.exp(-(2 * l - 1) * logits)))


def _resume_problem():
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=D)
    f = rng.normal(size=(N, M, D)).astype(np.float32)
    l = (f @ w_true > 0).astype(np.float32)
    return {"w": np.zeros(D, np.float32), "b": np.float32(0.0)}, (f, l)


RESUMES = {
    "porter-gc": dict(topology_schedule="rotate:ring+complete+star"),
    "dp-csgp": dict(sigma_p=0.0,
                    topology_schedule="directed:one_way,rate=0.3,period=3,"
                                      "skip=2"),
}


@pytest.mark.parametrize("name", sorted(RESUMES))
def test_resume_mid_period_continues_the_schedule(tmp_path, name):
    """Round t's W_t comes from the restored step, so a restart in the
    middle of a period picks the window up where it stopped: bitwise the
    port's uninterrupted run, within 1e-5 of the reference's.  The whole
    batch each round (no sampling), so both packages see the same data."""
    params0, data = _resume_problem()
    kw = dict(_spec_kw(name), n_agents=N, eta=0.1, frac=0.25,
              **RESUMES[name])
    sched = kw["topology_schedule"]

    def source(gen, t):
        return convert.to_torch(data, "cpu")

    def build():
        return tapi.build(tapi.ExperimentSpec(**kw), _logreg_t, device="cpu")

    algo = build()
    full, _ = run_chunked(algo, source, algo.init(
        convert.to_torch(params0, "cpu")), 7, 8, chunk=4)
    half, _ = run_chunked(algo, source, algo.init(
        convert.to_torch(params0, "cpu")), 7, 4, chunk=4)
    if name == "dp-csgp":
        assert not torch.allclose(half.xw, torch.ones(N), atol=1e-6)
    info = japi.algorithm_info(name)
    args = argparse.Namespace(topology_schedule=sched, plane_dtype=None,
                              tau=kw["tau"], epsilon=0.1, delta=1e-3,
                              local_samples=M, steps=8)
    extra = TT.ckpt_extra(info, args, kw["sigma_p"], 0, 0, 4)
    assert extra["topology_schedule"] == sched
    assert extra["rounds_executed"] == 4
    TC.save_state(str(tmp_path), half, step=4, extra=extra)
    man = TC.read_manifest(str(tmp_path))
    assert man["extra"]["topology_schedule"] == sched and man["step"] == 4

    # a fresh process: rebuild from the same spec, check, restore, go on
    algo2 = build()
    TT.check_resume(args, 4, 4, man["extra"])
    restored = TC.restore_state(str(tmp_path), like=algo2.init(
        convert.to_torch(params0, "cpu")))
    assert restored.step == 4 and type(restored.step) is int  # 4 % 3 = 1
    if name == "dp-csgp":
        assert torch.equal(restored.xw, half.xw)
        assert torch.equal(restored.q_w, half.q_w)
    resumed, _ = run_chunked(algo2, source, restored, 7, 8, chunk=4,
                             start=4)
    _assert_bitwise(resumed, full)
    assert resumed.step == 8

    ralgo = japi.build(japi.ExperimentSpec(**kw), _logreg_j)
    step = jax.jit(ralgo.step)
    rstate = ralgo.init(jax.tree_util.tree_map(jnp.asarray, params0))
    for t in range(8):
        rstate, _ = step(rstate, jax.tree_util.tree_map(jnp.asarray, data),
                         jax.random.PRNGKey(t))
    for got, want in zip(_tensors(resumed), jax.tree_util.tree_leaves(
            tuple(getattr(rstate, f) for f in rstate._fields
                  if f != "step"))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# refusals (tests/test_checkpoint.py), with the reference's messages
# ---------------------------------------------------------------------------

def _refusal(tmp_path, case):
    """Write a PorterState checkpoint with each package and restore it
    with each into ``like``: -> the two packages' exceptions."""
    _, jstate = _ref_run("porter-gc", None)
    tstate = convert.state_to_torch(jstate, "cpu")
    out = []
    for pkg, state in ((JC, jstate), (TC, tstate)):
        d = tmp_path / pkg.__name__.split(".")[0]
        pkg.save_state(str(d), state)
        like = state
        if case == "shape":
            like = (japi.build(japi.ExperimentSpec(**_spec_kw(
                "porter-gc", n_agents=3)), _loss_j).init(
                    jax.tree_util.tree_map(jnp.asarray, _params()))
                if pkg is JC else
                tapi.build(tapi.ExperimentSpec(**_spec_kw(
                    "porter-gc", n_agents=3)), _loss_t, device="cpu").init(
                    convert.to_torch(_params(), "cpu")))
        elif case == "keys":
            x = {"w": state.x["w"], "c": state.x["b"]}
            like = state._replace(x=x)
        elif case == "missing_buffer":
            (d / "step_00000003" / "v.npz").unlink()
        elif case == "missing_dir":
            d = d / "nope"
        elif case == "class":
            name = "choco"
            like = (_ref_run(name, None)[1] if pkg is JC
                    else _port_run(name)[1])
        with pytest.raises((ValueError, FileNotFoundError)) as err:
            pkg.restore_state(str(d), like=like)
        out.append((err.type, str(err.value).replace(
            str(tmp_path / "repro_torch"), "D").replace(
            str(tmp_path / "repro"), "D")))
    return out


@pytest.mark.parametrize("case", ["shape", "keys", "missing_buffer",
                                  "missing_dir", "class"])
def test_refusals_are_the_reference_refusals(tmp_path, case):
    want, got = _refusal(tmp_path, case)
    assert got == want
    expect = {"shape": "shape", "keys": "keys mismatch",
              "missing_buffer": "no buffer 'v'", "missing_dir":
              "no checkpoints", "class": "PorterState"}[case]
    assert expect in got[1]


# ---------------------------------------------------------------------------
# resume accounting (tests/test_runtime.py::test_resolve_privacy_fresh_vs_resume)
# ---------------------------------------------------------------------------

def _train_args(steps=40, tau=1.0, m=512, eps=0.1, delta=1e-3, **kw):
    return argparse.Namespace(steps=steps, tau=tau, local_samples=m,
                              epsilon=eps, delta=delta, **kw)


PRIVACY_CASES = {
    "fresh": ("porter-dp", 0, {}),
    "resume": ("porter-dp", 10, {"rounds_executed": 10, "sigma_p": 0.5}),
    "non_dp": ("porter-gc", 7, {"rounds_executed": 7}),
    "tau_changed": ("porter-dp", 10, {"rounds_executed": 10, "sigma_p": 0.5,
                                      "tau": 2.0, "local_samples": 512}),
    "samples_changed": ("porter-dp", 10, {"rounds_executed": 10,
                                          "sigma_p": 0.5, "tau": 1.0,
                                          "local_samples": 9999}),
    "no_sigma": ("porter-dp", 10, {}),
}


def _privacy(pkg_train, pkg_api, case):
    name, start, extra = PRIVACY_CASES[case]
    try:
        sigma, acct, prev = pkg_train.resolve_privacy(
            pkg_api.algorithm_info(name), _train_args(), start, extra)
    except ValueError as err:
        return "error", str(err)
    return sigma, None if acct is None else (acct.steps, acct.q,
                                             acct.noise_multiplier,
                                             acct.epsilon(1e-3)), prev


@pytest.mark.parametrize("case", sorted(PRIVACY_CASES))
def test_resolve_privacy_is_the_reference(case):
    got = _privacy(TT, tapi, case)
    assert got == _privacy(JT, japi, case)
    if case == "fresh":
        assert got[1][0] == 0 and got[2] == 0
    if case == "resume":
        assert got[0] == 0.5 and got[1][0] == 10 and got[2] == 10
    if case == "non_dp":
        assert got == (0.0, None, 7)
    match = {"tau_changed": "tau", "samples_changed": "local-samples",
             "no_sigma": "no sigma_p"}.get(case)
    if match:
        assert got[0] == "error" and match in got[1]


def test_accountant_grows_with_the_rounds_after_a_resume():
    sigma, acct, prev = TT.resolve_privacy(
        tapi.algorithm_info("porter-dp"), _train_args(), 10,
        {"rounds_executed": 10, "sigma_p": 0.5})
    eps_10 = acct.epsilon(1e-3)
    acct.step(30)  # the remaining rounds of the 40-step target
    assert acct.epsilon(1e-3) > eps_10


@pytest.mark.parametrize("knob", ["topology_schedule", "plane_dtype"])
def test_resume_refuses_another_schedule_or_plane_dtype(knob):
    saved = {"rounds_executed": 6, "topology_schedule": "erdos_renyi:period=4",
             "plane_dtype": "bf16"}
    args = _train_args(topology_schedule="erdos_renyi:period=4",
                       plane_dtype="bf16")
    TT.check_resume(args, 6, 6, saved)
    TT.check_resume(_train_args(topology_schedule=None, plane_dtype=None),
                    0, 0, saved)   # a fresh start checks nothing
    setattr(args, knob, None)
    flag = "--" + knob.replace("_", "-")
    with pytest.raises(ValueError, match=flag) as err:
        TT.check_resume(args, 6, 6, saved)
    assert f"the checkpoint's 6 rounds ran with {saved[knob]!r}" in str(
        err.value)


def test_ckpt_extra_records_what_a_resume_needs():
    args = _train_args(topology_schedule="dropout:rate=0.2,period=8",
                       plane_dtype="bf16")
    dp = TT.ckpt_extra(tapi.algorithm_info("porter-dp"), args, 0.7, 10, 10,
                       25)
    assert dp == {"rounds_executed": 25,
                  "topology_schedule": "dropout:rate=0.2,period=8",
                  "plane_dtype": "bf16", "sigma_p": 0.7, "tau": 1.0,
                  "epsilon": 0.1, "delta": 1e-3, "local_samples": 512}
    gc = TT.ckpt_extra(tapi.algorithm_info("porter-gc"),
                       _train_args(topology_schedule=None, plane_dtype=None),
                       0.0, 0, 0, 8)
    assert gc == {"rounds_executed": 8}

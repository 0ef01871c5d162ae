"""The fused EF updates' plain versions against the JAX reference, and the
``ops`` wrapper's dispatch rules.

``ef_track_ref`` / ``ef_step_ref`` are held against the reference's Pallas
kernels (``repro.kernels.ops`` at interpret=True) and its jnp oracles
(``repro.kernels.ref``) at odd sizes, atol 1e-6: the same f32 operations in
the same order, where XLA on the CPU may still round a fused product
differently by one ulp.  The CUDA kernels themselves cannot run here; they
are compared with these plain versions, bitwise, by ``chip_smoke.py`` on
the card.
"""

import importlib

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref

torch.set_num_threads(1)

GAMMA, ETA = 0.37, 0.05


def _operands(d, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(d).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("d", [1, 123, 8191, 9001])
def test_ef_track_ref_matches_reference(d):
    arrs = _operands(d, 7, d)
    ours = ref.ef_track_ref(*map(torch.from_numpy, arrs), GAMMA)
    pallas = jops.ef_track(*arrs, GAMMA, interpret=True)
    oracle = jref.ef_track_ref(*arrs, GAMMA)
    for a, p, o in zip(ours, pallas, oracle):
        np.testing.assert_allclose(a.numpy(), np.asarray(p), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.numpy(), np.asarray(o), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("d", [1, 123, 8191, 9001])
def test_ef_step_ref_matches_reference(d):
    arrs = _operands(d, 6, d + 1)
    ours = ref.ef_step_ref(*map(torch.from_numpy, arrs), GAMMA, ETA)
    pallas = jops.ef_step(*arrs, GAMMA, ETA, interpret=True)
    oracle = jref.ef_step_ref(*arrs, GAMMA, ETA)
    for a, p, o in zip(ours, pallas, oracle):
        np.testing.assert_allclose(a.numpy(), np.asarray(p), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.numpy(), np.asarray(o), rtol=0,
                                   atol=1e-6)


def test_ops_take_the_plain_path_for_cpu_tensors_and_count_nothing():
    ops.reset_launches()
    track = [torch.from_numpy(a).reshape(2, -1)
             for a in _operands(2 * 8192, 7, 0)]
    step = track[:6]
    got = ops.ef_track(*track, GAMMA)
    want = ref.ef_track_ref(*track, GAMMA)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = ops.ef_step(*step, GAMMA, ETA)
    want = ref.ef_step_ref(*step, GAMMA, ETA)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(ops.LAUNCHES.values()) == {0}
    assert build._LOADED == {}  # the CPU path never builds or loads


def test_ops_reject_what_the_kernels_do_not_take():
    planes = [torch.zeros(2, 8192) for _ in range(7)]
    bf16 = [p.clone() for p in planes]
    bf16[3] = bf16[3].to(torch.bfloat16)
    with pytest.raises(TypeError, match="operand mixes"):
        ops.ef_track(*bf16, GAMMA)
    strided = [p.clone() for p in planes]
    strided[0] = torch.zeros(8192, 2).t()
    with pytest.raises(ValueError, match="contiguous"):
        ops.ef_track(*strided, GAMMA)
    with pytest.raises(ValueError, match="shape"):
        ops.ef_step(*planes[:5], torch.zeros(1, 8192), GAMMA, ETA)


def test_kernel_module_imports_without_nvcc_and_builds_only_on_use(
        tmp_path, monkeypatch):
    mod = importlib.reload(importlib.import_module(
        "repro_torch.kernels.ef_update"))
    assert callable(mod.ef_track) and callable(mod.ef_step)
    path = build.library_path("ef_update")
    assert path.parent == build.BUILD_DIR and path.name.startswith(
        "libef_update-")
    # with no nvcc the build raises: there is no fallback to the CPU
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all(["ef_update"])

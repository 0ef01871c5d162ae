"""The port's flat tile-plane layout against the JAX reference's.

``to_planes`` must build the reference's planes element for element (odd,
non-tile-aligned shapes, stacked and unstacked), ``from_planes`` must invert
it and restore each leaf's dtype, and a mismatched agent axis must raise
(mirrors tests/test_comm_round.py::test_flatten_roundtrip_odd_shapes and
::test_flatten_rejects_mismatched_agent_axis).  Exact equality throughout:
packing only copies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flatten as JFL
from repro_torch import convert
from repro_torch.kernels import flatten as FL

torch.set_num_threads(1)

N = 5
# scalar leaf, non-multiple-of-8 vector, 3-D leaf, a leaf crossing a tile
ODD_SHAPES = {"b": (), "w": (123,), "k": (7, 11, 3), "big": (9000,)}


def _tree(stacked, seed=0):
    rng = np.random.default_rng(seed)
    lead = (N,) if stacked else ()
    return {k: rng.standard_normal(lead + s).astype(np.float32)
            for k, s in ODD_SHAPES.items()}


@pytest.mark.parametrize("stacked", [True, False])
def test_to_planes_equals_reference(stacked):
    tree = _tree(stacked)
    j_tree = {k: jnp.asarray(v) for k, v in tree.items()}
    j_spec = JFL.flat_spec(j_tree, stacked=stacked)
    t_tree = convert.to_torch(tree, "cpu")
    t_spec = FL.flat_spec(t_tree, stacked=stacked)
    assert (t_spec.rows, t_spec.d, t_spec.tiles, t_spec.sizes) == (
        j_spec.rows, j_spec.d, j_spec.tiles, j_spec.sizes)
    assert t_spec.plane_shape == j_spec.plane_shape
    planes = FL.to_planes(t_tree, t_spec)
    assert planes.is_contiguous() and planes.dtype == torch.float32
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(JFL.to_planes(j_tree, j_spec)))


@pytest.mark.parametrize("stacked", [True, False])
def test_from_planes_inverts_and_restores_dtypes(stacked):
    tree = convert.to_torch(_tree(stacked, seed=1), "cpu")
    # alternate f32 / bf16 leaves: the plane promotes to f32, unpack restores
    tree = {k: v.to(torch.bfloat16 if i % 2 else torch.float32)
            for i, (k, v) in enumerate(sorted(tree.items()))}
    spec = FL.flat_spec(tree, stacked=stacked)
    planes = FL.to_planes(tree, spec)
    assert planes.dtype == torch.float32
    assert planes.shape == spec.plane_shape and planes.shape[-1] == FL.TILE
    flat = planes.reshape(N if stacked else 1, -1)
    assert float(flat[:, spec.d:].abs().max()) == 0.0  # the pad is zero
    back = FL.from_planes(planes, spec)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert back[k].shape == tree[k].shape and back[k].is_contiguous()
        assert torch.equal(back[k], tree[k])


def test_flatten_rejects_mismatched_agent_axis():
    with pytest.raises(ValueError):
        FL.flat_spec({"a": torch.zeros(4, 3), "b": torch.zeros(5, 3)})
    with pytest.raises(ValueError):
        FL.flat_spec({})


def test_plane_apply_unpacks_each_output_with_its_own_layout():
    a = convert.to_torch(_tree(True, seed=2), "cpu")
    b = {k: v.to(torch.bfloat16) for k, v in
         convert.to_torch(_tree(True, seed=3), "cpu").items()}
    # output i comes back with the layout (leaf dtypes) of trees[i]
    out_b, out_a = FL.plane_apply(lambda pb, pa: (pb, pa), (b, a), 2)
    for k in a:
        assert out_a[k].dtype == torch.float32 and torch.equal(out_a[k], a[k])
        assert out_b[k].dtype == torch.bfloat16 and torch.equal(out_b[k], b[k])

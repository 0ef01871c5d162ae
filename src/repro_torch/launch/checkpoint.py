"""Checkpoints of decentralized training state, in the reference's format.

A copy of ``src/repro/launch/checkpoint.py`` for the port's states: one
``step_%08d/`` directory per checkpoint, one ``.npz`` per top-level state
field and a ``manifest.json`` with the step, the state class, the field
list, free-form ``extra`` metadata and every buffer's shape and dtype.

    save_state(dir, state, step=10, extra={"rounds_executed": 10})
    state = restore_state(dir, like=state)           # latest
    state = restore_state(dir, like=state, step=10)
    manifest = read_manifest(dir)                    # latest manifest dict

The npz keys are the reference's key paths (``jax.tree_util`` style): a
dict key as it is, a NamedTuple field as ``.name`` (a nested ``base``
gives ``.x/w``, ..., ``.step``), a sequence index as its number, and
``_root`` for a bare tensor or scalar field.  So a checkpoint written by
either package restores into the other, bitwise.

* The port's round counter is a host ``int``; it is stored as an int32
  scalar, as the reference stores its device int32.  Restore gives back a
  Python ``int`` wherever ``like`` holds one (a tensor step would make
  every round's ``table[t % period]`` wait for the device); the top-level
  ``step`` comes from the manifest, as in the reference.
* bf16 leaves are stored as their uint16 bit patterns (numpy has no
  bfloat16 of its own) and viewed back through ``like``'s dtype.
* Save copies every leaf to the host; restore puts every leaf on the
  device of ``like``'s leaf, and on no other.

``extra`` is recorded in the manifest; :mod:`repro_torch.launch.train`
keeps the privacy accounting there across resumes (``rounds_executed``,
``sigma_p``, ...), with the schedule and the plane dtype the rounds ran
under.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_flatten

__all__ = ["save_state", "restore_state", "latest_step", "read_manifest"]


def _key_paths(tree, prefix: Tuple[str, ...] = ()) -> List[str]:
    """The reference's npz key of every leaf of ``tree``, in leaf order
    (:func:`repro_torch.tree.tree_flatten`'s, which is ``jax.tree_util``'s)."""
    if isinstance(tree, dict):
        return [k for key in sorted(tree)
                for k in _key_paths(tree[key], prefix + (str(key),))]
    if hasattr(tree, "_fields"):
        return [k for name in tree._fields
                for k in _key_paths(getattr(tree, name),
                                    prefix + ("." + name,))]
    if isinstance(tree, (tuple, list)):
        return [k for i, child in enumerate(tree)
                for k in _key_paths(child, prefix + (str(i),))]
    if tree is None:
        return []
    return ["/".join(prefix) or "_root"]


def _to_numpy(leaf) -> np.ndarray:
    """Host copy in an npz-native dtype: a Python int as int32, a bf16
    tensor as its uint16 bit patterns."""
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> dict:
    leaves, _ = tree_flatten(tree)
    return {k: _to_numpy(leaf)
            for k, leaf in zip(_key_paths(tree), leaves)}


def _state_fields(state) -> tuple:
    fields = getattr(state, "_fields", None)
    if fields is None:
        raise TypeError(f"expected a NamedTuple state, got "
                        f"{type(state).__name__}")
    return fields


def _state_step(state) -> int:
    """The round counter, wherever the state keeps it (PorterAdamState and
    Clip21State nest it inside their PORTER base)."""
    if hasattr(state, "step"):
        return int(state.step)
    for name in _state_fields(state):
        v = getattr(state, name)
        if hasattr(v, "_fields"):
            try:
                return _state_step(v)
            except AttributeError:
                continue
    raise AttributeError(f"{type(state).__name__} carries no step counter")


def save_state(ckpt_dir: str, state: Any, step: Optional[int] = None,
               extra: Optional[dict] = None) -> str:
    step = _state_step(state) if step is None else step
    d = Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "state_cls": type(state).__name__,
                "fields": list(_state_fields(state)),
                "extra": dict(extra) if extra else {}, "buffers": {}}
    for name in _state_fields(state):
        flat = _flatten(getattr(state, name))
        np.savez(d / f"{name}.npz", **flat)
        manifest["buffers"][name] = {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in flat.items()
        }
    (d / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return str(d)


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest dict of the checkpoint at ``step`` (default latest)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text())


def _shape(leaf) -> tuple:
    return () if isinstance(leaf, int) else tuple(leaf.shape)


def _restore_leaf(arr: np.ndarray, like):
    if isinstance(like, int):
        return int(arr)
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        # stored as the u16 bit pattern (see _to_numpy): a bitwise view
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=like.device, dtype=like.dtype)


def _restore_field(d: Path, name: str, ref):
    paths = _key_paths(ref)
    leaves_ref, treedef = tree_flatten(ref)
    leaves = []
    with np.load(d / f"{name}.npz") as data:
        if set(data.files) != set(paths):
            raise ValueError(f"checkpoint buffer {name} keys mismatch: "
                             f"{sorted(set(data.files) ^ set(paths))[:5]}")
        for path_key, ref_leaf in zip(paths, leaves_ref):
            arr = data[path_key]
            if tuple(arr.shape) != _shape(ref_leaf):
                raise ValueError(f"{name}/{path_key}: shape {arr.shape} "
                                 f"!= {_shape(ref_leaf)}")
            leaves.append(_restore_leaf(arr, ref_leaf))
    return treedef.unflatten(leaves)


def restore_state(ckpt_dir: str, like: Any, step: Optional[int] = None):
    """Restore into the structure, class and devices of ``like``; shapes
    checked leaf by leaf."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    saved_cls = manifest.get("state_cls")
    if saved_cls is not None and saved_cls != type(like).__name__:
        raise ValueError(f"checkpoint holds a {saved_cls}, but restore was "
                         f"asked for a {type(like).__name__}")
    new = {}
    for name in _state_fields(like):
        if name == "step":
            # the manifest's step is authoritative (save_state's step=
            # override labels the checkpoint without mutating the state)
            new[name] = int(manifest["step"])
            continue
        if not (d / f"{name}.npz").exists():
            raise ValueError(f"checkpoint at {d} has no buffer {name!r}")
        new[name] = _restore_field(d, name, getattr(like, name))
    return type(like)(**new)

"""Carry weights and state between numpy and the port.

The bridge the parity tests use: the reference's arrays go through numpy
(``np.asarray`` of any array, no framework import here) into the port's
dicts of tensors, and back.

* :func:`to_torch` / :func:`to_numpy` -- a tree of arrays <-> the same tree
  of tensors (dicts, tuples, lists and NamedTuples keep their structure).
* :func:`state_to_torch` / :func:`state_to_numpy` -- a state namedtuple of
  arrays <-> the port's state of the same name: ``PorterState``,
  ``ChocoState``, ``DsgdState``, ``DpSgdState``, ``SoteriaState``,
  ``SubgradState``, ``DpCsgpState`` (every field a tree or an array, then
  ``step``), ``PorterAdamState`` or ``Clip21State`` (a ``PorterState``
  ``base`` beside trees).

* :func:`lm_params_to_torch` -- the reference's LM parameters (a tree of
  arrays, layer leaves stacked ``(n_layers, ...)``: ``layers`` for rwkv6,
  ``mamba`` beside the unstacked ``shared_attn`` for the hybrid) -> the
  port's.
* :func:`cache_to_torch` / :func:`cache_to_numpy` -- a serving cache both
  ways: rwkv6's recurrent state (``S``, ``shift_t``, ``shift_c``, each
  stacked over layers) or the hybrid's ``{"mamba": {"h", "conv"}, "attn":
  {"k", "v"}}`` (mamba leaves stacked over layers, attention over groups;
  a windowed attention cache adds ``positions``).

bf16: numpy has no bfloat16 of its own.  ``np.asarray`` of a JAX bf16
array is an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
rejects, so :func:`to_torch` carries it as its uint16 bit patterns and
views them as ``torch.bfloat16``; :func:`to_numpy` returns a bf16 tensor
as its uint16 bit patterns (``.view(ml_dtypes.bfloat16)`` on the caller's
side gives the values back).  Nothing here imports ``ml_dtypes``.

Wire buffers (:mod:`repro_torch.core.wire_formats`): torch's unsigned
types have few kernels, so the reference's u16 top-k indices cross as
int16 and its u32 qsgd words as int32, with the same bits (the indices are
below 2048, so their values are the same too).  :func:`to_torch` views a
uint16 / uint32 array so; :func:`wire_to_numpy` hands wire buffers back in
the reference's dtypes: int16 as uint16, int32 as uint32, bf16 as its
uint16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import baselines as BL
from .core.clip21 import Clip21State
from .core.porter import PorterState
from .core.porter_adam import PorterAdamState
from .core.push_sum import DpCsgpState
from .core.subgrad import SubgradState
from .tree import tree_leaves, tree_map

__all__ = ["to_torch", "to_numpy", "wire_to_numpy", "state_to_torch",
           "state_to_numpy", "lm_params_to_torch", "cache_to_torch",
           "cache_to_numpy"]

_STATES = {cls.__name__: cls for cls in (
    PorterState, BL.ChocoState, BL.DsgdState, BL.DpSgdState,
    BL.SoteriaState, SubgradState, DpCsgpState, PorterAdamState,
    Clip21State)}


_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def _tensor(a) -> torch.Tensor:
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype in _SIGNED:
        return torch.from_numpy(arr.view(_SIGNED[arr.dtype]))
    return torch.from_numpy(arr)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_torch(tree, device=None):
    """Copy a tree of arrays into tensors on ``device`` (cuda unless given)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return tree_map(lambda a: _tensor(a).to(device), tree)


def to_numpy(tree):
    """Copy a tree of tensors back to numpy arrays (bf16 as uint16 bits)."""
    return tree_map(_array, tree)


def wire_to_numpy(tree):
    """Wire buffers back to the reference's dtypes: int16 indices as
    uint16, int32 words as uint32, bf16 values as uint16 bits, others as
    they are."""
    unsigned = {torch.int16: np.uint16, torch.int32: np.uint32}

    def one(t):
        arr = _array(t)
        return arr.view(unsigned[t.dtype]) if t.dtype in unsigned else arr

    return tree_map(one, tree)


def _port_class(state):
    name = type(state).__name__
    if name not in _STATES:
        raise TypeError(f"no port state named {name}; have {sorted(_STATES)}")
    return _STATES[name]


def state_to_torch(state, device=None):
    """A state namedtuple of arrays -> the port's state of that name; a
    nested state (``base``) converts as a state, ``step`` to an int."""
    cls = _port_class(state)

    def field(name):
        value = getattr(state, name)
        if name == "step":
            return int(np.asarray(value))
        if type(value).__name__ in _STATES:
            return state_to_torch(value, device)
        return to_torch(value, device)

    return cls(**{f: field(f) for f in cls._fields})


def state_to_numpy(state):
    """The port's state -> the same class of numpy arrays (step as int32)."""
    cls = _port_class(state)

    def field(name):
        value = getattr(state, name)
        if name == "step":
            return np.int32(value)
        if type(value).__name__ in _STATES:
            return state_to_numpy(value)
        return to_numpy(value)

    return cls(**{f: field(f) for f in cls._fields})


_CACHE_KEYS = ("S", "shift_c", "shift_t")
_HYBRID_KEYS = {"mamba": (("conv", "h"),),
                "attn": (("k", "v"), ("k", "positions", "v"))}


def lm_params_to_torch(params, n_layers: int, device=None):
    """The reference's LM parameters (``bundle.init(key)[0]``: ``embed``,
    ``final_norm``, optionally ``head``, and the stacked layers: ``layers``
    (rwkv6) or ``mamba`` beside an unstacked ``shared_attn`` (hybrid), every
    stacked leaf over ``n_layers``) -> the same tree of tensors on
    ``device`` (cuda unless given)."""
    stacked = "layers" if "layers" in params else "mamba"
    missing = {"embed", "final_norm", stacked} - set(params)
    if missing:
        raise ValueError(f"not an LM parameter tree: no {sorted(missing)}")
    out = to_torch(params, device)
    bad = [tuple(t.shape) for t in tree_leaves(out[stacked])
           if t.dim() == 0 or t.shape[0] != n_layers]
    if bad:
        raise ValueError(f"layer leaves must be stacked over {n_layers} "
                         f"layers; got leaves of shapes {bad}")
    return out


def _check_cache(cache):
    if sorted(cache) == list(_CACHE_KEYS):
        return
    if (sorted(cache) == sorted(_HYBRID_KEYS) and all(
            tuple(sorted(cache[k])) in keys
            for k, keys in _HYBRID_KEYS.items())):
        return
    raise ValueError(f"an rwkv6 cache has the keys {_CACHE_KEYS}, a hybrid "
                     f"one {_HYBRID_KEYS}; got the keys {sorted(cache)}")


def cache_to_torch(cache, device=None):
    """The reference's serving cache (rwkv6 or hybrid) -> the port's, on
    ``device`` (cuda unless given), in the reference's dtypes (bf16
    attention caches as bf16)."""
    _check_cache(cache)
    return to_torch(cache, device)


def cache_to_numpy(cache):
    """The port's serving cache -> numpy arrays, the reference's layout
    (bf16 as uint16 bits)."""
    _check_cache(cache)
    return to_numpy(cache)

"""The CUDA kernels' radix select (``csrc/radix_select.cuh``), emulated on
the CPU with numpy: shared by ``test_torch_block_topk.py`` (the selection
of ``block_topk``) and ``test_torch_wire.py`` (the k-th largest magnitude
behind ``topk_pack``'s threshold).

|x| is ordered as the integer key bits & 0x7fffffff (f32) or bits & 0x7fff
(bf16); the k-th largest key is found a digit at a time, most significant
first, from a 256-bin histogram of the digits of the keys that share the
digits found so far.  The passes stop once all of those keys are wanted
(their count equals the rank still sought).
"""

import numpy as np

_PASSES = {4: ((23, 8), (15, 8), (7, 8), (0, 7)), 2: ((7, 8), (0, 7))}
_TOP = {4: 31, 2: 15}
_UINT = {4: np.uint32, 2: np.uint16}


def keys(win):
    """(raw bit patterns, keys) of an ``(nb, 2048)`` f32 or bf16 array, as
    int64."""
    size = win.dtype.itemsize
    raw = win.view(_UINT[size]).astype(np.int64)
    return raw, raw & ((1 << _TOP[size]) - 1)


def select(key, k, size):
    """The select on one window's keys: (prefix, krem, eq, low, passes).
    ``prefix`` holds the digits found (the key's bits from ``low`` up),
    ``krem`` the rank still sought among the ``eq`` keys that share them."""
    prefix, krem, low, eq = 0, k, _TOP[size], 0
    for n_pass, (shift, width) in enumerate(_PASSES[size], 1):
        high = shift + width
        sel = key if high >= _TOP[size] else key[(key >> high) == prefix]
        hist = np.bincount((sel >> shift) & ((1 << width) - 1),
                           minlength=256)
        cum = np.cumsum(hist[::-1])            # counts from the top bin
        at = int(np.argmax(cum >= krem))
        digit = 255 - at
        eq = int(hist[digit])
        krem -= int(cum[at]) - eq
        prefix, low = (prefix << width) | digit, shift
        if eq == krem:
            break
    return prefix, krem, eq, low, n_pass


def kth_key(key, k, size):
    """The k-th largest key: after an early stop the smallest key of the
    bucket (the keys that share the prefix; ``topk_pack`` reads it from its
    bin's minimum), else the digits found, which are the whole key."""
    prefix, krem, eq, low, _ = select(key, k, size)
    if eq == krem:
        return int(key[(key >> low) == prefix].min())
    return prefix


def radix_select(win, k, passes=None):
    """``block_topk``'s selection on an ``(nb, 2048)`` numpy f32 or bf16
    array; returns the same dtype, +0.0 where not kept.  ``passes``, a
    list, gets the number of digit passes each window took."""
    size = win.dtype.itemsize
    raw, keys_ = keys(win)
    out = np.zeros_like(raw)
    for w, key in enumerate(keys_):
        prefix, krem, eq, low, n_pass = select(key, k, size)
        if passes is not None:
            passes.append(n_pass)
        if eq == krem:
            keep = (key >> low) >= prefix
        else:
            keep = key > prefix
            keep[np.flatnonzero(key == prefix)[:krem]] = True
        out[w] = np.where(keep, raw[w], 0)
    return out.astype(_UINT[size]).view(win.dtype)

"""Architecture registry (``src/repro/configs/__init__.py``) beside the
paper's experiment protocols (``paper_logreg``, ``paper_mnist``).

``get_config("rwkv6-7b")`` / ``get_smoke("rwkv6-7b")``; arch ids use hyphens
(CLI style), module files use underscores.  The port has the rwkv6-7b and
zamba2-7b configs; the other arches of the reference are listed and raise
until their family is ported (ROADMAP queue 1 item 13).
"""
from importlib import import_module

ARCHS = [
    "rwkv6-7b", "minicpm3-4b", "seamless-m4t-medium", "tinyllama-1.1b",
    "h2o-danube-3-4b", "chatglm3-6b", "grok-1-314b", "arctic-480b",
    "paligemma-3b", "zamba2-7b",
]

_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-7b": "zamba2_7b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; have {ARCHS}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP queue 1 item 13); the port "
            f"has {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE

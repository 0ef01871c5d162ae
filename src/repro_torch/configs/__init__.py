"""Architecture registry (``src/repro/configs/__init__.py``) beside the
paper's experiment protocols (``paper_logreg``, ``paper_mnist``).

``get_config("rwkv6-7b")`` / ``get_smoke("rwkv6-7b")``; arch ids use hyphens
(CLI style), module files use underscores.  All ten architectures of the
reference, each ``CONFIG`` and ``SMOKE`` field-equal to its own (the
dtype a ``torch.dtype``).
"""
from importlib import import_module

ARCHS = [
    "rwkv6-7b", "minicpm3-4b", "seamless-m4t-medium", "tinyllama-1.1b",
    "h2o-danube-3-4b", "chatglm3-6b", "grok-1-314b", "arctic-480b",
    "paligemma-3b", "zamba2-7b",
]

_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "minicpm3-4b": "minicpm3_4b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "chatglm3-6b": "chatglm3_6b",
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
    "paligemma-3b": "paligemma_3b",
    "zamba2-7b": "zamba2_7b",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; have {ARCHS}")
    return import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE

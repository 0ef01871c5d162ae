"""Model zoo: the rwkv6 and hybrid (zamba2) families (``blocks``,
``model``) and the paper's Section-5.2 MLP (``paper``)."""
from .blocks import ModelConfig
from .model import ModelBundle, build_model
from .paper import mlp_init, mlp_loss

__all__ = ["ModelConfig", "ModelBundle", "build_model", "mlp_init",
           "mlp_loss"]

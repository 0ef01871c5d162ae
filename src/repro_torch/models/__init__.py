"""Model zoo: every family of the reference -- the dense, MLA, MoE and VLM
decoders, rwkv6, the hybrid (zamba2) and the encoder-decoder (``blocks``,
``model``) -- and the paper's Section-5.2 MLP (``paper``)."""
from .blocks import ModelConfig
from .model import ModelBundle, build_model
from .paper import mlp_init, mlp_loss

__all__ = ["ModelConfig", "ModelBundle", "build_model", "mlp_init",
           "mlp_loss"]

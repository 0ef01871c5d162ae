"""Neural-net modules of the model zoo: ``module``, ``ssm`` (RWKV6 and
Mamba2), the GQA half of ``attention`` and the MLP half of ``moe``."""

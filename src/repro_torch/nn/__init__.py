"""Neural-net modules of the model zoo (this slice: ``module`` and the
RWKV6 half of ``ssm``)."""

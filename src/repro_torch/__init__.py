"""repro_torch: the PyTorch/CUDA port of ``repro`` (PORTER, Li & Chi 2023),
for one NVIDIA H100.

Module paths mirror the JAX reference (``repro_torch.core.comm_round`` <->
``repro.core.comm_round``); the port imports neither JAX nor ``repro``.
Entry points run on ``torch.device("cuda")`` unless the caller passes
``device=``.  The fused error-feedback kernels are hand-written CUDA
(``csrc/``), built with ``nvcc`` at first use.

f32 matrix products are kept in full f32 on the card: the dense mixer's
``W @ c`` is an f32 product in the reference, and TF32 would keep about
three decimal digits of it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

"""The port's decoder bundles (``repro_torch.models.model._build_decoder``:
dense, MLA, MoE, VLM) against the JAX package's on the seven smoke configs
of ``tests/test_torch_decoder_model.py``, in f32 and in bf16: ``forward``,
``prefill`` (the last-token logits and every cache leaf) and one
``decode_step`` (its logits and cache) over 24 positions, the VLM's 8
patches among them.

Tolerances (``tests/lm_parity.py``, the gates of
``tests/test_torch_zamba2_model.py`` with their reasons): f32 normwise
1e-4, decode from the reference's prefill cache grown by one slot; bf16,
decode from the port's own prefill cache grown by ``launch.serve.
grow_cache``, each output's RMS error from the reference's f32 result
within 0.5 to 1.25 times the reference's own bf16 RMS error from it.
"""

import pytest
import torch

from lm_parity import DECODERS, check_bundle

torch.set_num_threads(2)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_bundle_matches_reference(arch, dt):
    ratios = check_bundle(arch, dt, 24)
    assert {"forward", "prefill", "decode"} <= set(ratios)

"""Batched serving example on the PyTorch port (the counterpart of
``examples/serve_batched.py``): prefill a prompt batch and greedy-decode
from a hybrid (Mamba2 + shared attention) model's smoke config, or from any
other architecture's with ``--arch``.

    PYTHONPATH=src python examples/serve_batched_torch.py          # the card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
    PYTHONPATH=src python examples/serve_batched_torch.py --arch minicpm3-4b

It runs on the card unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.launch.serve import main

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="zamba2-7b")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
raise SystemExit(main(["--arch", args.arch, "--smoke", "--batch", "2",
                       "--prompt-len", "32", "--gen", "12",
                       "--device", args.device]))

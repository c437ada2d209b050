"""PyTorch / CUDA port of ``pfpn_tpu``.

The package mirrors the module paths of the JAX package: every module here
names the JAX function it replaces and is held against it in
``tests/test_torch_*.py``. Plain tensor code is PyTorch; the kernels are
hand-written CUDA (``csrc/``, built and loaded by ``ops/_build.py``): the
30 Hz control-step "megastep" of the acting path (``ops/megastep.py``), and
the substep's linear algebra (``ops/substep_lin.py``) and the SPD inverse
(``ops/linalg.py``) of the per-substep path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA without a card raises (:func:`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for and missing: there is no silent CPU
    fallback. On CUDA, pins fp32 matmuls and convolutions to full float32
    (no TF32), the counterpart of ``f32_precision`` in the JAX dynamics.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

"""PyTorch/CUDA port of the HALO serving system.

``src/repro/`` (JAX) is the reference; this package mirrors its file names
so every ported module has one named counterpart.  It imports neither JAX
nor anything of the reference package.

Float32 matrix products run in full float32 on the card: TF32 and reduced-
precision bf16 reductions are switched off once, here, so that
``models.layers.matmul``'s "f32 accumulation, cast back" holds for every
caller.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Nothing falls back to the CPU by itself — asking for
    ``cuda`` on a machine without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch path")
    return dev

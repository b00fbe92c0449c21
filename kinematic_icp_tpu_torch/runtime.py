"""Device selection for the package's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when CUDA is asked for and absent:
    the entry points never fall back to the CPU on their own.

    Also turns TF32 off for float32 matmuls and convolutions, the
    counterpart of the JAX pipeline's ``default_matmul_precision("highest")``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev

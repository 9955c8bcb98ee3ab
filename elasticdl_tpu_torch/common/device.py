"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, ``"cpu"`` must be passed explicitly (the tests do),
and asking for CUDA on a machine without it raises instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; expected 'cuda' or 'cpu'")
    return dev


def set_matmul_precision() -> None:
    """Full-f32 matrix products on the card, so f32 comparisons mean f32:
    TF32 keeps about three decimal digits.  Both flags are process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

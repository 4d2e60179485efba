"""Device placement for the solve phase.

Solve-phase tensors go to ``cuda`` unless the caller names another
device; the CPU is used only when asked for (the tests pass
``device="cpu"``).  Nothing falls back to the CPU by itself.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "solve phase on the CPU")
    return device


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A host array (or tensor) as a contiguous tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        t = a.to(device=device, dtype=dtype)
    else:
        import numpy as np
        # a read-only array (a view of another library's buffer) is copied
        t = torch.as_tensor(np.require(a, requirements="CW"), dtype=dtype,
                            device=device)
    return t.contiguous()

"""Device selection and the float32 policy of the port.

The JAX reference computes its float paths in full float32 (its resize
matmuls run at `Precision.HIGHEST`, `ops/resize.py:121`). On the card, PyTorch
may route float32 matmuls and convolutions through TF32, which keeps about
three decimal digits; the port never allows that.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(c: float) -> float:
    """`c` rounded to float32, as a Python float.

    The JAX code writes its constants as `jnp.float32(c)`. Multiplying a
    float32 tensor by this value gives the same bits whether PyTorch does
    the scalar arithmetic in float32 or in double, because a double
    product, sum or quotient of two float32 values rounds to the float32
    result."""
    return float(np.float32(c))


def resolve_device(name: str | torch.device) -> torch.device:
    """The device `name` names, checked: asking for CUDA where there is no
    CUDA raises instead of quietly running on the CPU. For CUDA it also sets
    the float32 policy: float32 matmuls and convolutions stay in full
    float32 (no TF32)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (use 'cuda' or 'cpu')")
    return dev


def on_device(x, device: str | torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` (resolved and checked
    by `resolve_device`)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(resolve_device(device))

"""Math helpers shared by module definitions and runtime code (torch).

Counterpart of the JAX package's ``utils/math.py``. Angles use the native
``torch.atan2``/``torch.atan``.
"""

from __future__ import annotations

import math

import torch


def rotation_matrix(angle):
    """2D rotation matrix of a 0-d or batched angle tensor: (..., 2, 2)."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def haar_difference_without_abs(angle1, angle2):
    """Signed angular difference ``fmod(a1 - a2 + pi, 2 pi) - pi`` with C
    ``fmod`` semantics (the sign follows the dividend), as ``torch.fmod``.

    The constants are tensors of the angle's dtype: under ``torch.func``
    forward-over-reverse, a 0-d f32 tensor minus a Python float gives f64
    second derivatives."""
    d = angle1 - angle2
    pi = torch.as_tensor(math.pi, dtype=d.dtype, device=d.device)
    return torch.fmod(d + pi, 2.0 * pi) - pi


def exponential_quantile(rate: float, p):
    """Quantile of the exponential distribution, ``-log(1 - p) / rate``
    (the ellipsoid risk inflation ``chi = Q(0.5, 1 - risk)``). ``p`` is a
    float or a tensor."""
    if isinstance(p, torch.Tensor):
        return -torch.log(1.0 - p) / rate
    return -math.log(1.0 - p) / rate

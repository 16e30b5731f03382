"""Math helpers shared by module definitions and runtime code (torch).

Counterpart of the JAX package's ``utils/math.py``. Angles use the native
``torch.atan2``/``torch.atan`` and the error function the native
``torch.erf``.
"""

from __future__ import annotations

import math

import numpy as np
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
    second derivatives. They are filled on the device, not copied there
    (a copy from the host waits for the device)."""
    d = angle1 - angle2
    pi = torch.full((), math.pi, dtype=d.dtype, device=d.device)
    return torch.fmod(d + pi, 2.0 * pi) - pi


def exponential_quantile(rate: float, p):
    """Quantile of the exponential distribution, ``-log(1 - p) / rate``
    (the ellipsoid risk inflation ``chi = Q(0.5, 1 - risk)``). ``p`` is a
    float or a tensor."""
    if isinstance(p, torch.Tensor):
        return -torch.log(1.0 - p) / rate
    return -math.log(1.0 - p) / rate


def erfinv_newton(x):
    """Inverse error function of a tensor: a rational initial guess, then two
    Newton steps on ``erf(y) = x`` (the JAX package's scheme, which the CC-MPC
    chance constraint uses; native ``torch.erf``)."""
    z = torch.sqrt(-torch.log((1.0 - x) / 2.0))
    y = (((1.641345311 * z + 3.429567803) * z - 1.624906493) * z
         - 1.970840454) / ((1.637067800 * z + 3.543889200) * z + 1.0)
    two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)
    for _ in range(2):
        y = y - (torch.erf(y) - x) / (two_over_sqrt_pi * torch.exp(-y * y))
    return y


def np_haar_difference(angle1, angle2):
    """numpy :func:`haar_difference_without_abs` for host code."""
    return np.fmod(angle1 - angle2 + np.pi, 2.0 * np.pi) - np.pi


def wrap_angle(a):
    """Wrap an angle (numpy) to (-pi, pi]."""
    return np.arctan2(np.sin(a), np.cos(a))

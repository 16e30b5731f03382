"""PyTorch/CUDA port of the T-MPC++ planner engine, for one NVIDIA H100.

The JAX package beside it in this repository is the reference; this package
mirrors its layout and names and imports neither it nor JAX. The first slice covers the T-MPC++
fleet step: the OCP of the bench configuration, linearized with
``torch.func``, and its QP subproblems solved by a hand-written interior-point
kernel (``csrc/qp_ip.cu``, built with nvcc for sm_90a at first use), one launch
per SQP iteration. On CPU tensors the kernel's plain PyTorch version runs
instead.
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401

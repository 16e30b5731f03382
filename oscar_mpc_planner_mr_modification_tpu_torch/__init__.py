"""PyTorch/CUDA port of the T-MPC++ planner engine, for one NVIDIA H100.

The JAX package beside it in this repository is the reference; this package
mirrors its layout and names and imports neither it nor JAX. It covers the
T-MPC++ fleet step (``parallel.batch``) on the fused whole-SQP kernel
(``csrc/sqp_fused.cu``), the per-iteration interior-point kernel
(``csrc/qp_ip.cu``) and the lane path, and the single-robot planner tick
(``factory.build_planner``: ``planner.Planner``, ``solver.Solver``,
``parallel.tmpc.TMPCOptimizer``, the guidance PRM of ``guidance/`` with its
C++ search ``native/prm.cpp``), one fused launch per tick. The kernels are
built with nvcc for sm_90a at first use; on CPU tensors their plain PyTorch
versions run instead.
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401

"""The PyTorch port imports neither JAX nor the JAX package.

Checked on the source text: the test process itself imports JAX, so
``sys.modules`` cannot tell.
"""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "oscar_mpc_planner_mr_modification_tpu_torch"
JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
JAX_PACKAGE = re.compile(r"oscar_mpc_planner_mr_modification_tpu(?!_torch)")
JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(import|from)\s+oscar_mpc_planner_mr_modification_tpu(?!_torch)\b",
    re.M)

PORT_FILES = sorted(p for p in PORT.rglob("*")
                    if p.suffix in (".py", ".cu", ".cuh", ".h", ".cpp"))


def test_port_has_sources():
    names = {p.relative_to(PORT).as_posix() for p in PORT_FILES}
    assert {"csrc/qp_ip.cu", "csrc/qp_ip.cuh", "csrc/sqp_fused.cu",
            "csrc/tmpc_ocp.cuh", "csrc/tmpc_ocp_host.cpp", "csrc/fma_roof.cu",
            "csrc/qp_ip_count.cpp", "csrc/warp.cuh", "csrc/sqp_fused.cuh",
            "ops/qp_cuda.py", "ops/sqp.py", "ops/sqp_fused.py",
            "ops/linearize.py", "ops/roofline.py", "parallel/batch.py",
            "tools/bench_roofline.py", "tools/bench_warm.py",
            "tools/kernel_check.py", "types.py", "factory.py",
            "planner/planner.py", "planner/data_preparation.py",
            "solver/solver.py", "solver/state.py", "parallel/tmpc.py",
            "guidance/global_guidance.py", "guidance/homotopy.py",
            "guidance/cpp_backend.py", "native/prm.cpp",
            "utils/profiling.py", "sim/pedestrians.py",
            "sim/roadmap.py", "ops/qp.py", "parallel/rollout.py",
            "models/dynamics.py", "modules/goal_module.py",
            "tools/bench_rollout.py", "modules/gaussian_constraints.py",
            "modules/scenario_constraints.py", "parallel/scenario.py",
            "tools/bench_matrix.py", "modules/path_reference_velocity.py",
            "metrics.py", "systems.py", "multirobot/__init__.py",
            "multirobot/comms.py", "multirobot/driver.py",
            "multirobot/interpolation.py", "multirobot/transport.py",
            "multirobot/vehicle_io.py", "sim/environment.py",
            "utils/datasaver.py", "modules/curvature_aware_contouring.py",
            "modules/contouring_constraints.py",
            "modules/decomp_constraints.py", "ops/decomp.py",
            "ops/decomp_native.py", "native/decomp.cpp", "parallel/mesh.py",
            "dashboard.py", "dashboard_web.py", "utils/logging.py",
            "utils/visualization.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_port_file_names_no_jax(path):
    text = path.read_text()
    assert not JAX_IMPORT.search(text), f"{path} imports jax"
    assert not JAX_PACKAGE.search(text), f"{path} names the JAX package"


def test_chip_smoke_imports_no_jax():
    text = (ROOT / "chip_smoke.py").read_text()
    assert not JAX_IMPORT.search(text)
    assert not JAX_PACKAGE_IMPORT.search(text)

from .ocp import OCP, build_ocp  # noqa: F401
from .solver import Solver  # noqa: F401
from .state import State  # noqa: F401

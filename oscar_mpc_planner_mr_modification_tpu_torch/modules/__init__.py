from .base import Module, ObjectiveModule, ConstraintModule, ModuleManager  # noqa: F401
from .mpc_base import MPCBaseModule  # noqa: F401
from .contouring import ContouringModule  # noqa: F401
from .consistency_module import ConsistencyModule  # noqa: F401
from .ellipsoid_constraints import EllipsoidConstraintModule  # noqa: F401
from .linearized_constraints import LinearizedConstraintModule  # noqa: F401
from .guidance_constraints import GuidanceConstraintModule  # noqa: F401

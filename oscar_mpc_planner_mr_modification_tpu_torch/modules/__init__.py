from .base import Module, ObjectiveModule, ConstraintModule, ModuleManager  # noqa: F401
from .mpc_base import MPCBaseModule  # noqa: F401
from .contouring import ContouringModule  # noqa: F401
from .goal_module import GoalModule  # noqa: F401
from .consistency_module import ConsistencyModule  # noqa: F401
from .ellipsoid_constraints import EllipsoidConstraintModule  # noqa: F401
from .linearized_constraints import LinearizedConstraintModule  # noqa: F401
from .guidance_constraints import GuidanceConstraintModule  # noqa: F401
from .gaussian_constraints import GaussianConstraintModule  # noqa: F401
from .scenario_constraints import ScenarioConstraintModule  # noqa: F401
from .path_reference_velocity import PathReferenceVelocityModule  # noqa: F401
from .curvature_aware_contouring import CurvatureAwareContouringModule  # noqa: F401
from .contouring_constraints import ContouringConstraintModule  # noqa: F401
from .decomp_constraints import DecompConstraintModule  # noqa: F401

from .planner import Planner  # noqa: F401
from . import data_preparation  # noqa: F401

from .pedestrians import PedestrianSimulator, Pedestrian  # noqa: F401
from . import roadmap  # noqa: F401

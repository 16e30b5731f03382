from .pedestrians import PedestrianSimulator, Pedestrian  # noqa: F401
from . import roadmap  # noqa: F401
from .environment import EpisodeResult, SimEnvironment  # noqa: F401

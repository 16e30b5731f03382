from .params import ParameterRegistry  # noqa: F401
from .config import Config, default_settings  # noqa: F401

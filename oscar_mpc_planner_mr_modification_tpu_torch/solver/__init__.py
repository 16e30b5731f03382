from .ocp import OCP, build_ocp  # noqa: F401

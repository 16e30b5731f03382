from .spline import Spline, Spline2D, eval_spline, eval_spline_deriv, eval_spline_deriv2  # noqa: F401

from .homotopy import winding_signature, signature_vector, same_homotopy_class  # noqa: F401
from .global_guidance import GlobalGuidance, GuidanceTrajectory, Goal  # noqa: F401

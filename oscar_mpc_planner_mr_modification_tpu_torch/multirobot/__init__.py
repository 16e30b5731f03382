"""Multi-robot coordination: triggers, interpolation, driver, transport
and vehicle IO."""

from .comms import CommunicationTriggerReason, CommunicationTriggers  # noqa: F401
from .interpolation import (collision_mask_gk, geometric_deviation,  # noqa: F401
                            interpolate_trajectory_by_elapsed_time)
from .driver import MessageBus, MultiRobotDriver, RobotAgent  # noqa: F401
from .vehicle_io import (MockViconIO, PoseMeasurement,  # noqa: F401
                         RealVehicleAgent, TrackedObject, VehicleIO,
                         update_noncommunicating_obstacles)

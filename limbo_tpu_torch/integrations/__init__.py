"""External-system integrations (ROS).

The BO host loop takes any Python callable as the objective, so an
integration is a thin marshalling adapter; the device path is untouched.
"""

from limbo_tpu_torch.integrations.ros import RosObjective, make_ros_objective

__all__ = ["RosObjective", "make_ros_objective"]

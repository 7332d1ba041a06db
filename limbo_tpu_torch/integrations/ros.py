"""ROS adapter: drive the BO loop with an objective evaluated by a robot
(port of limbo_tpu/integrations/ros.py).

Reference: package.xml + src/tutorials/ros.py, catkin / REP-136 packaging
and a waf detection shim so that limbo experiments can link roscpp and call
ROS services from the objective functor.  Here the objective is a Python
callable run on the host between device steps (bo/optimizer.py), so ROS
support is a marshalling adapter:

* ``make_ros_objective(transport, dim_out)`` wraps any request / response
  callable (a rclpy service client's ``call``, a rospy ``ServiceProxy``,
  or a test fake) into a BO objective.  The candidate goes out as plain
  Python floats; the response comes back validated (finite, the right
  arity) as a (dim_out,) float32 NumPy array, which the loop takes as any
  observation.  An invalid response raises ``EvaluationError``, as an
  in-process NaN observation does (bo_base.hpp:232-238).
* ``RosObjective`` adds optional retries for flaky transports.

This module imports no ROS package: the caller builds the node and passes
its client (``node.create_client(...).call`` for ROS 2, ``rospy.
ServiceProxy(...)`` for ROS 1), so rclpy is imported only where a node is
built.

Example (ROS 2)::

    import rclpy
    from limbo_tpu_torch.bo import BOptimizer
    from limbo_tpu_torch.integrations import make_ros_objective

    rclpy.init()
    node = rclpy.create_node("bo_client")
    client = node.create_client(EvalSrv, "/robot/evaluate")
    f = make_ros_objective(
        lambda xs: client.call(EvalSrv.Request(params=xs)).rewards,
        dim_out=1)
    BOptimizer().optimize(f, dim_in=4)
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np

from limbo_tpu_torch.bo.optimizer import EvaluationError


def _to_request(x) -> list:
    """A candidate (array or tensor) -> plain Python floats (what ROS
    message fields take)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return [float(v) for v in np.asarray(x).ravel()]


def _to_observation(resp, dim_out: int) -> np.ndarray:
    """ROS response (message, sequence, or scalar) -> validated (p,) f32
    array.  Accepts a bare scalar, any sequence of floats, or a message
    object exposing one of the conventional reward fields."""
    if resp is None:
        raise EvaluationError("ROS transport returned None (service down?)")
    for field in ("rewards", "values", "observation", "data", "y"):
        if hasattr(resp, field):
            resp = getattr(resp, field)
            break
    if isinstance(resp, (int, float)):
        vals = [float(resp)]
    else:
        vals = [float(v) for v in resp]
    if len(vals) != dim_out:
        raise EvaluationError(
            f"ROS response arity {len(vals)} != dim_out {dim_out}")
    if any(math.isnan(v) or math.isinf(v) for v in vals):
        raise EvaluationError(f"non-finite ROS observation {vals}")
    return np.asarray(vals, dtype=np.float32)


class RosObjective:
    """Objective backed by a ROS request / response transport.

    transport: callable taking a list of floats (the candidate x) and
    returning the observation (scalar, sequence, or message object).
    retries / retry_wait_s: re-issue the request on transport exceptions
    (service restarts are routine on robots); an EvaluationError from a
    well-formed but invalid response is never retried, it is the loop's
    NaN-guard signal.
    """

    def __init__(self, transport: Callable, dim_out: int = 1,
                 retries: int = 0, retry_wait_s: float = 0.5,
                 sleeper: Callable[[float], None] = time.sleep):
        self.transport = transport
        self.dim_out = dim_out
        self.retries = retries
        self.retry_wait_s = retry_wait_s
        self._sleep = sleeper
        self.n_calls = 0

    def __call__(self, x) -> np.ndarray:
        req = _to_request(x)
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                self.n_calls += 1
                return _to_observation(self.transport(req), self.dim_out)
            except EvaluationError:
                raise
            except Exception as e:          # transport-level failure
                last_err = e
                if attempt < self.retries:
                    self._sleep(self.retry_wait_s)
        raise EvaluationError(f"ROS transport failed after "
                              f"{self.retries + 1} attempts: {last_err}")


def make_ros_objective(transport: Callable, dim_out: int = 1,
                       retries: int = 0) -> RosObjective:
    """Convenience wrapper; see RosObjective."""
    return RosObjective(transport, dim_out=dim_out, retries=retries)

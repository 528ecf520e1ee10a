"""Managed-lifecycle node base — the ``BaseAMCLNode`` surface (a copy of
``beluga_tpu/lifecycle.py``, which imports no JAX).

The reference's nodes are ROS 2 *managed lifecycle* nodes
(``beluga_amcl/include/beluga_amcl/ros2_common.hpp:59-145``,
``src/ros2_common.cpp:36-374``): a state machine
UNCONFIGURED → INACTIVE → ACTIVE with ``on_configure`` / ``on_activate``
/ ``on_deactivate`` / ``on_cleanup`` / ``on_shutdown`` callbacks, ``do_*``
extension points for subclasses, an ``autostart`` option that drives the
node straight to ACTIVE, and a 200 ms periodic timer for visualization
publishing.  This module reproduces that contract middleware-free:

  * transitions are explicit method calls, validated against the
    lifecycle graph (invalid transitions raise ``LifecycleError``);
  * ``do_configure/do_activate/do_deactivate/do_cleanup/do_shutdown``
    are subclass extension points, called AFTER the base bookkeeping like
    the reference's ``do_*`` virtuals;
  * timers are cooperative: ``add_timer(period_s, cb)`` registers a
    callback and ``tick(now)`` fires the due ones — drivers embed the
    node in their own loop (there is no hidden thread, matching the
    repo's explicit-driver design); the periodic viz timer
    (``ros2_common.cpp`` 200 ms ``timer_callback``) is registered on
    activate and removed on deactivate.
"""

from __future__ import annotations

import enum
import time
from typing import Callable

# forward time-base jump (beyond one period) treated as a clock switch rather
# than a long stall; one hour safely exceeds any real inter-tick gap while
# being far below the monotonic-vs-epoch offset (~1.7e9 s)
_TIMER_BASE_JUMP_S = 3600.0


class LifecycleState(enum.Enum):
    UNCONFIGURED = "unconfigured"
    INACTIVE = "inactive"
    ACTIVE = "active"
    FINALIZED = "finalized"


class LifecycleError(RuntimeError):
    pass


_TRANSITIONS = {
    # transition: (allowed source states, destination)
    "configure": ((LifecycleState.UNCONFIGURED,), LifecycleState.INACTIVE),
    "activate": ((LifecycleState.INACTIVE,), LifecycleState.ACTIVE),
    "deactivate": ((LifecycleState.ACTIVE,), LifecycleState.INACTIVE),
    "cleanup": ((LifecycleState.INACTIVE,), LifecycleState.UNCONFIGURED),
    "shutdown": (
        (LifecycleState.UNCONFIGURED, LifecycleState.INACTIVE,
         LifecycleState.ACTIVE),
        LifecycleState.FINALIZED,
    ),
}


class BaseLifecycleNode:
    """Lifecycle state machine + cooperative timers.

    Subclasses override the ``do_*`` hooks; the base validates the
    transition, runs the hook, then commits the new state (a hook raising
    aborts the transition, like a lifecycle callback returning FAILURE).
    """

    VIZ_TIMER_PERIOD_S = 0.2  # ros2_common.cpp timer_callback period

    def __init__(self, autostart: bool = False):
        self.lifecycle_state = LifecycleState.UNCONFIGURED
        self._timers: dict[str, tuple[float, float | None, Callable[[], None]]] = {}
        self.transition_log: list[str] = []
        if autostart:
            # the reference's autostart timer triggers configure+activate
            # right after construction (ros2_common.cpp autostart_timer_)
            self.configure()
            self.activate()

    # -- transitions --------------------------------------------------------

    def _transition(self, name: str, hook: Callable[[], None]):
        sources, dest = _TRANSITIONS[name]
        if self.lifecycle_state not in sources:
            raise LifecycleError(
                f"cannot {name} from {self.lifecycle_state.value}"
            )
        hook()
        self.lifecycle_state = dest
        self.transition_log.append(name)

    def configure(self):
        self._transition("configure", self.do_configure)

    def activate(self):
        def hook():
            self.do_activate()
            self.add_timer("viz", self.VIZ_TIMER_PERIOD_S,
                           self.do_periodic_timer_callback)

        self._transition("activate", hook)

    def deactivate(self):
        def hook():
            self.remove_timer("viz")
            self.do_deactivate()

        self._transition("deactivate", hook)

    def cleanup(self):
        self._transition("cleanup", self.do_cleanup)

    def shutdown(self):
        def hook():
            self._timers.clear()
            self.do_shutdown()

        self._transition("shutdown", hook)

    @property
    def is_active(self) -> bool:
        return self.lifecycle_state is LifecycleState.ACTIVE

    # -- do_* extension points (ros2_common.hpp protected virtuals) ---------

    def do_configure(self):  # pragma: no cover - default no-op
        pass

    def do_activate(self):  # pragma: no cover
        pass

    def do_deactivate(self):  # pragma: no cover
        pass

    def do_cleanup(self):  # pragma: no cover
        pass

    def do_shutdown(self):  # pragma: no cover
        pass

    def do_periodic_timer_callback(self):  # pragma: no cover
        pass

    # -- cooperative timers -------------------------------------------------

    def add_timer(self, name: str, period_s: float, cb: Callable[[], None]):
        # the phase base is pinned lazily to the FIRST tick's clock so a
        # driver may pass any monotone time base (sim time, wall epoch,
        # monotonic) — mixing time.monotonic() here with a driver clock in
        # tick() would make timers never (or always) fire
        self._timers[name] = (period_s, None, cb)

    def remove_timer(self, name: str):
        self._timers.pop(name, None)

    def tick(self, now: float | None = None) -> int:
        """Fire every due timer; returns the number fired.  Drivers call
        this from their loop (the rclcpp-executor analog) with their own
        monotone clock (or no argument for time.monotonic())."""
        now = time.monotonic() if now is None else now
        fired = 0
        for name, (period, last, cb) in list(self._timers.items()):
            if last is None:
                self._timers[name] = (period, now, cb)
            elif now < last or now - last > period + _TIMER_BASE_JUMP_S:
                # time-base jump (driver switched clocks between ticks, e.g.
                # its own sim clock vs the time.monotonic() default): re-pin
                # the phase base instead of firing never / immediately
                self._timers[name] = (period, now, cb)
            elif now - last >= period:
                self._timers[name] = (period, now, cb)
                cb()
                fired += 1
        return fired

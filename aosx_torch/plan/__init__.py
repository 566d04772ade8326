from . import astar, control, linearize, mission  # noqa: F401
from .mission import build_waypoints, mission_tick, plan_current_path  # noqa: F401

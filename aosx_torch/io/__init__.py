"""Host IO of the port (mirror of ``aosx.io``): state checkpoints, PCD maps,
ROS message dictionaries and the episode figure."""

from .checkpoint import load_state, save_state  # noqa: F401
from .pcd import load_pcd, save_pcd  # noqa: F401

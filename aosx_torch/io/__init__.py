"""State persistence of the port (mirror of ``aosx.io``; the PCD reader and
renderer are not ported yet)."""

from .checkpoint import load_state, save_state  # noqa: F401

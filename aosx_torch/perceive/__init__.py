from .pipeline import PerceiveOut, perceive  # noqa: F401

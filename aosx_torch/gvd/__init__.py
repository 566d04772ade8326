from .graph import build_gvd_graph  # noqa: F401

from .recompute import recompute  # noqa: F401

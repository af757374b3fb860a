from .linalg import bmm, matmul, mm  # noqa: F401
from .manipulation import flatten  # noqa: F401

from .linalg import bmm, matmul, mm  # noqa: F401

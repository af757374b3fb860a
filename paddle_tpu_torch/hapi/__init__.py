from .dynamic_flops import flops  # noqa: F401

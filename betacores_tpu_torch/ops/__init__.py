from . import kernels, projection

__all__ = ["kernels", "projection"]

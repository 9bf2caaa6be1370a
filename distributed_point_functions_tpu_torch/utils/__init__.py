"""Small host-side helpers of the serving runtime."""

from .runtime import get_backend_mode_string

__all__ = ["get_backend_mode_string"]

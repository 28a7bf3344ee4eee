"""utils/ — runtime precision policy."""
from .runtime import setup

__all__ = ["setup"]

from .registry import Registry

__all__ = ["Registry"]

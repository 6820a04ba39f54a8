from .builder import build_detector

__all__ = ["build_detector"]

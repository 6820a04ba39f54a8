__all__ = ["build_detector"]


def __getattr__(name):
    # on first use: the ops modules import models.init, and the builder
    # imports the ops modules
    if name == "build_detector":
        from .builder import build_detector
        return build_detector
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

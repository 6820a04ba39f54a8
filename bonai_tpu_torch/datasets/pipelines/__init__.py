from .inference import InferencePipeline
from .transforms import (PIPELINES, Collect, Compose, DefaultFormatBundle,
                         LoadAnnotations, LoadImageFromFile, Normalize, Pad,
                         RandomFlip, Resize, build_pipeline)

__all__ = ["PIPELINES", "Collect", "Compose", "DefaultFormatBundle",
           "InferencePipeline", "LoadAnnotations", "LoadImageFromFile",
           "Normalize", "Pad", "RandomFlip", "Resize", "build_pipeline"]

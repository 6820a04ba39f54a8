from .transforms import (PIPELINES, Collect, Compose, DefaultFormatBundle,
                         ImageToTensor, LoadAnnotations, LoadImageFromFile,
                         MultiScaleFlipAug, Normalize, Pad, RandomFlip,
                         Resize, build_pipeline)
from .corrupt import Corrupt, corrupt_image

__all__ = ["PIPELINES", "Collect", "Compose", "Corrupt",
           "DefaultFormatBundle",
           "ImageToTensor", "LoadAnnotations", "LoadImageFromFile",
           "MultiScaleFlipAug", "Normalize", "Pad", "RandomFlip", "Resize",
           "build_pipeline", "corrupt_image"]

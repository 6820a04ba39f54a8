from .transforms import (PIPELINES, Collect, Compose, DefaultFormatBundle,
                         ImageToTensor, LoadAnnotations, LoadImageFromFile,
                         MultiScaleFlipAug, Normalize, Pad, RandomFlip,
                         Resize, build_pipeline)

__all__ = ["PIPELINES", "Collect", "Compose", "DefaultFormatBundle",
           "ImageToTensor", "LoadAnnotations", "LoadImageFromFile",
           "MultiScaleFlipAug", "Normalize", "Pad", "RandomFlip", "Resize",
           "build_pipeline"]

from .bonai import BONAI
from .builder import (DATASETS, DataLoader, build_dataloader, build_dataset,
                      pack_sample, rasterize_instance_mask)
from .coco import CocoDataset
from .coco_api import COCOIndex
from .pipelines import PIPELINES, build_pipeline

__all__ = ["BONAI", "COCOIndex", "CocoDataset", "DATASETS", "DataLoader",
           "PIPELINES", "build_dataloader", "build_dataset",
           "build_pipeline", "pack_sample", "rasterize_instance_mask"]

from .bonai import BONAI
from .builder import (DATASETS, ClassBalancedDataset, DataLoader,
                      RepeatDataset, build_dataloader, build_dataset,
                      pack_sample, rasterize_instance_mask)
from .coco import CocoDataset
from .coco_api import COCOIndex
from .extra import (CityscapesDataset, DeepFashionDataset, LVISDataset,
                    VOCDataset, WIDERFaceDataset, XMLDataset)
from .pipelines import PIPELINES, build_pipeline

__all__ = ["BONAI", "COCOIndex", "CityscapesDataset", "ClassBalancedDataset",
           "CocoDataset", "DATASETS", "DataLoader", "DeepFashionDataset",
           "LVISDataset", "PIPELINES", "RepeatDataset", "VOCDataset",
           "WIDERFaceDataset", "XMLDataset", "build_dataloader",
           "build_dataset", "build_pipeline", "pack_sample",
           "rasterize_instance_mask"]

from .bonai_eval import (dump_csv, load_csv, masks_to_polygons,
                         merge_crop_records, offset_error_vector, polygon_f1,
                         results_to_csv_records)
from .coco_eval import coco_ap, evaluate_coco
from .mean_ap import eval_map, eval_recalls

__all__ = ["coco_ap", "dump_csv", "eval_map", "eval_recalls",
           "evaluate_coco", "load_csv", "masks_to_polygons",
           "merge_crop_records", "offset_error_vector", "polygon_f1",
           "results_to_csv_records"]

from .bonai_eval import (dump_csv, load_csv, masks_to_polygons,
                         merge_crop_records, offset_error_vector, polygon_f1,
                         results_to_csv_records)

__all__ = ["dump_csv", "load_csv", "masks_to_polygons", "merge_crop_records",
           "offset_error_vector", "polygon_f1", "results_to_csv_records"]

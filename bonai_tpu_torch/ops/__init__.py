from .roi_align import map_roi_levels, multilevel_roi_align
from .roi_align_block import (block_levels, roi_align_block,
                              roi_align_block_backward, roi_align_block_ref)

__all__ = ["block_levels", "map_roi_levels", "multilevel_roi_align",
           "roi_align_block", "roi_align_block_backward",
           "roi_align_block_ref"]

from .roi_align import map_roi_levels, multilevel_roi_align
from .roi_align_block import (block_levels, roi_align_block,
                              roi_align_block_backward, roi_align_block_ref)
from .roi_align_blocked import roi_align_blocked
from .roi_align_fused import (roi_align_fused, roi_align_fused_backward,
                              roi_align_fused_ref, strip_levels)
from .roi_align_strip import roi_align_strip, roi_align_strip_ref

__all__ = ["block_levels", "map_roi_levels", "multilevel_roi_align",
           "roi_align_block", "roi_align_block_backward",
           "roi_align_block_ref", "roi_align_blocked", "roi_align_fused",
           "roi_align_fused_backward", "roi_align_fused_ref",
           "roi_align_strip", "roi_align_strip_ref", "strip_levels"]

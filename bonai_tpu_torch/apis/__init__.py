from .inference import inference_detector, init_detector, prepare_batch
from .test import results_to_host

__all__ = ["inference_detector", "init_detector", "prepare_batch",
           "results_to_host"]

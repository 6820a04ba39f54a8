from .inference import inference_detector, init_detector, prepare_batch
from .test import results_to_host
from .train import train_detector

__all__ = ["inference_detector", "init_detector", "prepare_batch",
           "results_to_host", "train_detector"]

from .inference import inference_detector, init_detector, prepare_batch
from .test import results_to_host, run_inference
from .train import train_detector

__all__ = ["inference_detector", "init_detector", "prepare_batch",
           "results_to_host", "run_inference", "train_detector"]

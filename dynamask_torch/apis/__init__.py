from .inference import inference_detector, init_detector, show_result
from .test import (dataset_mask_canvas, paste_epilogue, run_eval, run_test,
                   single_device_test)
from .train import init_trainer, synthetic_batch, train_detector

__all__ = ['inference_detector', 'init_detector', 'show_result',
           'dataset_mask_canvas', 'paste_epilogue', 'run_eval', 'run_test',
           'single_device_test', 'init_trainer', 'synthetic_batch',
           'train_detector']

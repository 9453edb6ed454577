from .inference import inference_detector, init_detector, show_result
from .test import (dataset_mask_canvas, make_test_fn, paste_epilogue,
                   run_eval, run_test, single_device_test)
from .train import (config_shapes, get_root_logger, init_trainer,
                    set_random_seed, synthetic_batch, train_detector,
                    train_steps)

__all__ = ['inference_detector', 'init_detector', 'show_result',
           'dataset_mask_canvas', 'make_test_fn', 'paste_epilogue',
           'run_eval', 'run_test',
           'single_device_test', 'config_shapes', 'get_root_logger',
           'init_trainer', 'set_random_seed', 'synthetic_batch',
           'train_detector', 'train_steps']

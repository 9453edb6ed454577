from .inference import inference_detector, init_detector, show_result
from .test import (aug_device_test, dataset_mask_canvas, make_test_fn,
                   multi_device_test, paste_epilogue, run_eval, run_test,
                   single_device_test)
from .train import (config_shapes, get_root_logger, init_trainer,
                    semantic_seg_shape, set_random_seed, synthetic_batch,
                    train_detector, train_steps)

__all__ = ['inference_detector', 'init_detector', 'show_result',
           'aug_device_test', 'dataset_mask_canvas', 'make_test_fn',
           'multi_device_test',
           'paste_epilogue', 'run_eval', 'run_test',
           'single_device_test', 'config_shapes', 'get_root_logger',
           'init_trainer', 'semantic_seg_shape', 'set_random_seed',
           'synthetic_batch',
           'train_detector', 'train_steps']

from .inference import inference_detector, init_detector
from .test import paste_epilogue
from .train import init_trainer, synthetic_batch, train_detector

__all__ = ['inference_detector', 'init_detector', 'paste_epilogue',
           'init_trainer', 'synthetic_batch', 'train_detector']

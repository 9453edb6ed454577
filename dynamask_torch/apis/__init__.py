from .inference import inference_detector, init_detector
from .test import paste_epilogue

__all__ = ['inference_detector', 'init_detector', 'paste_epilogue']

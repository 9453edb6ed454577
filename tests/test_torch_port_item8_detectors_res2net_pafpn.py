"""The toy twins of Mask R-CNN on Res2Net-50 and Faster R-CNN on PAFPN
on the CPU against the JAX package: the checks of
``tests/test_torch_port_item8_detectors.py`` (``simple_test``, one
``forward_train``'s losses and per-leaf gradients with the sampler draws
injected, the K2/K4 calls of an image and a step), in a file of their own
so that the two halves run side by side.
"""

import os
import sys

import pytest

pytest.importorskip('torch')
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_item8_detectors import (  # noqa: E402
    check_crop_calls_per_path, check_per_leaf_gradients, check_simple_test,
    check_train_losses)

KINDS = ['res2net', 'pafpn']


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    check_train_losses(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_per_leaf_gradients(kind):
    check_per_leaf_gradients(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_crop_calls_per_path(kind):
    check_crop_calls_per_path(kind)

"""Toy twins of RepPoints' moment and minmax transforms (the two
exact-gather DCNs a level, the init stage on ``PointAssigner``, the refine
stage on ``MaxIoUAssigner``) on the CPU against the JAX package; the
partial-minmax transform runs in ``test_torch_port_item6_detectors_nas.py``
to balance the files. The checks of
``tests/test_torch_port_item6_detectors.py`` (``simple_test``, one
float64 ``forward_train``'s losses and gradients), in a file of their own
so that the files run side by side.
"""

import os
import sys

import pytest

pytest.importorskip('torch')
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_item6_detectors import (  # noqa: E402
    check_simple_test, check_train_step)

KINDS = ['reppoints', 'reppoints_minmax']


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_train_step(kind):
    check_train_step(kind)

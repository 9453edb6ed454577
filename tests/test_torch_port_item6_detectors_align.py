"""Toy twins of the align FoveaBox (the FeatureAlign's exact-gather DCN in
4 groups, GN in the head) and RepPoints' grid form (``use_grid_points``)
on the CPU against the JAX package: the checks of
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

KINDS = ['fovea_align', 'reppoints_grid']


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_train_step(kind):
    check_train_step(kind)

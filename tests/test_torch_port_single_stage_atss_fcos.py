"""The toy twins of ATSS and FCOS (the center-sampling, ``norm_on_bbox``,
centerness-on-reg GN config) on the CPU against the JAX package: the
checks of ``tests/test_torch_port_single_stage.py`` (``simple_test``,
``forward_train``'s losses, one optimizer step's parameters), in a file
of their own so that the two halves run side by side.
"""

import os
import sys

import pytest

pytest.importorskip('torch')
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_single_stage import (  # noqa: E402
    check_one_step_parameters, check_simple_test, check_train_losses)

KINDS = ['atss', 'fcos']


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_train_losses(kind):
    check_train_losses(kind)


@pytest.mark.parametrize('kind', KINDS)
def test_one_step_parameters(kind):
    check_one_step_parameters(kind)

"""The toy twins of NAS-FCOS with its searched head (the windowed DCNv2
towers) and searched neck, and of RepPoints' partial-minmax transform, on
the CPU against the JAX package: ``simple_test`` as in
``tests/test_torch_port_item6_detectors.py``; one float64
``forward_train``'s losses and gradients for RepPoints, its losses alone
for NAS-FCOS, at 3 of its 5 levels (``NAS_LEVELS``). JAX compiles the
DCNv2 towers a level (over a minute for a step's gradients at the
config's 5), so NAS-FCOS' gradients are held at the head and the neck
(``tests/test_torch_port_item6_modules.py``:
``test_heads_match_jax[nas_fcos]``, ``test_nasfcos_neck_matches_jax``).
"""

import os
import sys

import pytest

pytest.importorskip('torch')
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_item6_detectors import (  # noqa: E402
    check_losses, check_simple_test, check_train_step)

KINDS = ['nas_fcos', 'reppoints_partial_minmax']


@pytest.mark.parametrize('kind', KINDS)
def test_simple_test(kind):
    check_simple_test(kind)


def test_train_losses_nas_fcos():
    check_losses('nas_fcos')


def test_train_step_reppoints_partial_minmax():
    check_train_step('reppoints_partial_minmax')

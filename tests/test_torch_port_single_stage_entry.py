"""The single-stage detectors through every entry point on the CPU, boxes
only, as Faster R-CNN's path: ``make_test_fn``, ``single_device_test`` and
the dataset's bbox ``evaluate`` on a seeded COCO set (each image's dets
those of the JAX package's ``simple_test`` on the same sample),
``train_detector`` with validation, ``init_detector`` from its work dir,
``inference_detector`` on an image file, ``run_eval``, and the train and
eval CLIs (``python -m dynamask_torch.tools.train`` / ``.test``, their
``main``), at the toy widths of ``tests/test_torch_port_single_stage.py``.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_eval_slice import (TEST_PIPELINE,  # noqa: E402
                                        TRAIN_PIPELINE, data_cfg, make_set)
from test_torch_port_single_stage import toy_cfg, twin  # noqa: E402


@pytest.fixture(scope='module')
def coco_set(tmp_path_factory):
    return make_set(tmp_path_factory.mktemp('single_stage_coco'))


def test_test_loop_matches_jax_image_by_image(coco_set):
    """``single_device_test`` of the RetinaNet twin: boxes only (no masks,
    no proposals), each image's dets, labels and validity those of JAX's
    ``simple_test`` on the same sample; ``evaluate`` gives bbox AP."""
    from dynamask_torch.apis import single_device_test
    from dynamask_torch.apis.test import is_proposal_model
    from dynamask_torch.data import build_dataset
    det, variables, port = twin('retina')
    assert not is_proposal_model(port)
    ds = build_dataset(data_cfg(*coco_set, TEST_PIPELINE),
                       dict(test_mode=True))
    results = single_device_test(port, ds, workers_per_gpu=0,
                                 progress=False)
    index = {ds.sample_id(i): i for i in range(len(ds))}
    assert sorted(r['img_id'] for r in results) == sorted(index)
    for r in results:
        assert 'masks' not in r and 'proposals' not in r
        s = ds[index[r['img_id']]]
        ref = jax.device_get(jax.jit(lambda v, b: det.apply(
            v, b, method='simple_test'))(variables, {
                k: jnp.asarray(s[k])[None]
                for k in ('image', 'img_shape', 'scale_factor')}))
        assert ref['det_valid'][0].sum() >= 4
        np.testing.assert_array_equal(r['valid'], ref['det_valid'][0])
        np.testing.assert_array_equal(r['labels'], ref['labels'][0])
        np.testing.assert_allclose(r['dets'], ref['dets'][0], rtol=1e-5,
                                   atol=1e-4)
    metrics = ds.evaluate(results, metric=['bbox'])
    assert 0 <= metrics['bbox_mAP'] <= 1


def test_make_test_fn_bf16_keeps_fp32_dets():
    """``make_test_fn(..., bf16=True)`` on the ATSS twin: the model given
    stays fp32, the dets come out fp32 and valid."""
    from dynamask_torch.apis import make_test_fn
    from test_torch_port_single_stage import demo
    _, _, port = twin('atss')
    batch = {k: torch.from_numpy(v) for k, v in demo(2).items()
             if k in ('image', 'img_shape', 'scale_factor')}
    out = make_test_fn(port, (64, 64), bf16=True)(batch)
    assert out['dets'].dtype == torch.float32 and 'masks' not in out
    assert int(out['valid'].sum()) > 0
    assert all(p.dtype == torch.float32 for p in port.parameters())


def _run_cfg(coco_set, kind):
    from dynamask_torch.utils import Config
    model, train_cfg, test_cfg = toy_cfg(kind)
    return Config(dict(
        model=model, train_cfg=train_cfg, test_cfg=test_cfg,
        optimizer=dict(type='SGD', lr=0.002, momentum=0.9,
                       weight_decay=1e-4),
        optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=5,
                       warmup_ratio=0.001, step=[8, 11]),
        total_epochs=1, log_config=dict(interval=1),
        evaluation=dict(interval=1, metric=['bbox']),
        data=dict(samples_per_gpu=2, workers_per_gpu=0, max_gts=8,
                  mask_crop_size=32,
                  train=data_cfg(*coco_set, TRAIN_PIPELINE),
                  val=data_cfg(*coco_set, TEST_PIPELINE),
                  test=data_cfg(*coco_set, TEST_PIPELINE))))


@pytest.mark.parametrize('kind', ['retina', 'fcos'])
def test_train_and_eval_entry_points(coco_set, kind, tmp_path):
    """``train_detector`` for one step with validation, the checkpoint
    through ``init_detector`` (every key), ``inference_detector`` on an
    image file (the per-class box lists alone) and ``run_eval``."""
    from dynamask_torch.apis import (inference_detector, init_detector,
                                     run_eval, train_detector)
    from test_torch_port_train_loop import rows
    cfg = _run_cfg(coco_set, kind)
    work = str(tmp_path / 'work')
    train_detector(cfg, work_dir=work, max_steps_per_epoch=1, device='cpu')
    train = [r for r in rows(work) if r['mode'] == 'train']
    val = [r for r in rows(work) if r['mode'] == 'val']
    assert len(train) == 1 and len(val) == 1
    assert {'loss_cls', 'loss_bbox'} <= set(train[0])
    assert ('loss_centerness' in train[0]) == (kind == 'fcos')
    assert np.isfinite(val[0]['bbox_mAP'])
    model = init_detector(cfg, checkpoint=work, device='cpu')
    assert len(model.CLASSES) == 8
    saved = torch.load(os.path.join(work, 'epoch_1.pth'),
                       weights_only=True)['state_dict']
    assert saved.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    result = inference_detector(model, os.path.join(coco_set[1], '0000.jpg'))
    assert isinstance(result, list) and len(result) == 8
    assert all(r.ndim == 2 and r.shape[1] == 5 for r in result)
    metrics = run_eval(cfg, work, metrics=('bbox',), device='cpu')
    assert np.isfinite(metrics['bbox_mAP'])


def test_train_and_eval_clis(coco_set, tmp_path, capsys):
    """The train CLI one step on the toy ATSS, then the eval CLI on the
    work dir it wrote (bbox)."""
    from test_torch_port_eval_slice import _write_cfg
    from test_torch_port_train_loop import rows
    from dynamask_torch.tools.test import main as test_main
    from dynamask_torch.tools.train import main as train_main
    cfg = _write_cfg(tmp_path / 'cfg.py',
                     _run_cfg(coco_set, 'atss').to_dict())
    work = str(tmp_path / 'work')
    assert train_main([cfg, '--work-dir', work, '--device', 'cpu',
                       '--max-steps-per-epoch', '1', '--no-validate']) == 0
    train = [r for r in rows(work) if r['mode'] == 'train']
    assert len(train) == 1 and np.isfinite(train[0]['loss_centerness'])
    assert test_main([cfg, work, '--device', 'cpu', '--eval', 'bbox']) == 0
    assert 'bbox_mAP:' in capsys.readouterr().out

"""The port's counterpart of ``tests/test_overfit.py``: does the port's
training loop learn? The toy DynaMask config of ``tests/test_integration.py``
with the JAX proxy's recipe (all-stage instance loss, 4 images, backbone
unfrozen on batch statistics, lr 0.01, 80 epochs, no flip) through
``dynamask_torch.apis.train_detector`` on the CPU, then ``run_eval`` on
the loop's checkpoint. The JAX proxy scores bbox / segm mAP 0.4847 /
0.6199 at its seed 0 (``ACCURACY.json``), 0.46-0.49 / 0.62-0.72 over seeds
0-1, and collapses to 0.05 at seed 2: the proxy is sensitive to its init.

Two starts: the port's own seeded init, and the JAX loop's init carried
into the port (``load_from``), which separates the loop from the
initialisers. Each run takes ~3-4 minutes; like ``test_overfit.py`` the
file runs under the ``overfit`` marker (``pytest -m overfit``).
"""

import json
import os
import statistics
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

pytestmark = [pytest.mark.slow, pytest.mark.overfit]

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))


def _overfit_cfg(tmp_path):
    from test_data import make_synthetic_coco
    from test_integration import toy_cfg
    from dynamask_torch.utils import Config
    ann_file, img_dir = make_synthetic_coco(tmp_path, num_imgs=4)
    d = toy_cfg(ann_file, img_dir, tmp_path, 'DynaMaskRoIHead').to_dict()
    m = d['model']
    m['roi_head']['bbox_head']['num_classes'] = 2
    m['roi_head']['mask_head']['stage_num_classes'] = [2, 2, 2, 1]
    m['backbone']['frozen_stages'] = -1
    m['backbone']['norm_eval'] = False
    m['roi_head']['mask_head']['loss_cfg']['all_stage_instance_loss'] = True
    d['optimizer']['lr'] = 0.01
    d['lr_config'].update(step=[1000], warmup_iters=10)
    d.update(total_epochs=80, checkpoint_config=dict(interval=80))
    d['data']['workers_per_gpu'] = 0
    d['data']['train']['pipeline'] = [
        t for t in d['data']['train']['pipeline'] if t['type'] != 'RandomFlip']
    d.pop('work_dir')
    return Config(d)


def _overfit_run(cfg, work, load_from=None):
    """80 epochs, then the metrics; asserts the loss halves."""
    from dynamask_torch.apis import run_eval, train_detector
    train_detector(cfg, work_dir=work, seed=0, device='cpu', validate=False,
                   load_from=load_from)
    loss = {}
    for name in os.listdir(work):
        if name.endswith('.log.json'):
            for line in open(os.path.join(work, name)):
                r = json.loads(line)
                loss.setdefault(r['epoch'], []).append(r['loss'])
    first, last = statistics.mean(loss[1]), statistics.mean(loss[80])
    metrics = run_eval(cfg, work, ('bbox', 'segm'), device='cpu')
    print(f'port overfit: mean loss {first:.4f} -> {last:.4f}, bbox_mAP '
          f'{metrics["bbox_mAP"]:.4f}, segm_mAP {metrics["segm_mAP"]:.4f}')
    assert last < first / 2
    return metrics


def test_port_overfits_from_its_own_init(tmp_path):
    metrics = _overfit_run(_overfit_cfg(tmp_path), str(tmp_path / 'work'))
    assert metrics['bbox_mAP'] >= 0.25, metrics
    assert metrics['segm_mAP'] >= 0.4, metrics


def test_port_overfits_from_the_jax_init(tmp_path):
    """The JAX loop's init (``dynamask_tpu/apis/train.py:121-125``: the
    first half of ``PRNGKey(seed)``'s split, on the first batch) carried
    into the port."""
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.data import build_dataloader, build_dataset
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfg = _overfit_cfg(tmp_path)
    d = cfg.to_dict()
    det = jax_build(d['model'], d['train_cfg'], d['test_cfg'])
    ds = build_dataset(dict(cfg.data['train']),
                       dict(max_gts=8, mask_crop_size=32))
    b0 = next(iter(build_dataloader(ds, 2, workers_per_gpu=0)))
    b0 = {k: jnp.asarray(v.numpy()) for k, v in b0.items() if k != 'img_id'}
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    port = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                          device='cpu')
    load_jax_variables(port, jax.device_get(jax.jit(det.init)(
        {'params': init_rng}, b0)))
    init = str(tmp_path / 'jax_init.pth')
    torch.save(port.state_dict(), init)
    metrics = _overfit_run(cfg, str(tmp_path / 'work'), load_from=init)
    assert metrics['bbox_mAP'] >= 0.4, metrics
    assert metrics['segm_mAP'] >= 0.55, metrics
    assert np.isfinite(list(metrics.values())).all()

"""The training entry point on the CPU: ``dynamask_torch.apis.train_detector``
(the epoch loop with its logs, checkpoints, resume, ``load_from``,
``pretrained`` and validation), ``engine.checkpoint``, ``engine.pretrained``,
the dataset wrappers and the CLI ``python -m dynamask_torch.tools.train``,
each against the JAX package where it has a counterpart.

The toy is the DynaMask toy of ``tests/test_integration.py:toy_cfg`` (2
classes, 160x128 canvases, batch 2) on ``tests/test_data.py:
make_synthetic_coco`` with 8 images: 4 landscape and 4 portrait, so the
loader has 4 batches an epoch, which ``max_steps_per_epoch`` cuts to 2 (the
lr schedule counts in the cut epochs: ``lr_config.step=[1]`` decays at
step 2). The loader works in the test process (``workers_per_gpu=0``),
except in the CLI test.

Tolerances: resume on the CPU is bit for bit (same process, same threads,
every piece of state restored). The logged lr equals the JAX schedule,
which computes in fp32, to 1e-6 relative. A port checkpoint read by the
JAX package gives the port's ``simple_test`` outputs to 1e-4 absolute
(fp32 in other summation orders, as ``test_torch_port_slice.py``).
"""

import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402
from test_torch_port_modules import fast_jit  # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_IMAGES = 8
STEPS = 2          # of the loader's 4 batches an epoch
# the keys of the JAX loop's train rows besides the step's log
# (dynamask_tpu/apis/train.py:221-223)
LOOP_KEYS = {'mode', 'epoch', 'iter', 'step', 'lr', 'time'}


def toy_config(ann_file, img_dir, workers=0, **top):
    """``test_integration.toy_cfg`` as a port ``Config``: the DynaMask toy at
    2 classes, 2 epochs, validation after each (bbox and segm)."""
    from test_integration import toy_cfg
    from dynamask_torch.utils import Config
    d = toy_cfg(ann_file, img_dir, pathlib.Path(ann_file).parent,
                'DynaMaskRoIHead').to_dict()
    d.pop('work_dir')
    rh = d['model']['roi_head']
    rh['bbox_head']['num_classes'] = 2
    rh['mask_head']['stage_num_classes'] = [2, 2, 2, 1]
    d['data']['workers_per_gpu'] = workers
    d.update(total_epochs=2, evaluation=dict(interval=1,
                                              metric=['bbox', 'segm']))
    d.update(top)
    return Config(d)


def rows(work_dir):
    return [json.loads(line) for f in sorted(glob.glob(os.path.join(
        work_dir, '*.log.json'))) for line in open(f)]


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    from test_data import make_synthetic_coco
    return make_synthetic_coco(tmp_path_factory.mktemp('coco_train'),
                               num_imgs=NUM_IMAGES)


@pytest.fixture(scope='module')
def runs(coco, tmp_path_factory):
    """Run A: two epochs straight. Run B: one epoch, then resumed from its
    work dir for the second."""
    from dynamask_torch.apis import train_detector
    root = tmp_path_factory.mktemp('runs')
    kw = dict(seed=0, max_steps_per_epoch=STEPS, device='cpu',
              validate=False)
    a = train_detector(toy_config(*coco), work_dir=str(root / 'A'), **kw)
    train_detector(toy_config(*coco, total_epochs=1),
                   work_dir=str(root / 'B'), **kw)
    b = train_detector(toy_config(*coco), work_dir=str(root / 'B'),
                       resume_from=str(root / 'B'), **kw)
    return root, a, b


@pytest.fixture(scope='module')
def jax_det(coco):
    from dynamask_tpu.models import build_detector
    cfg = toy_config(*coco).to_dict()
    return build_detector(cfg['model'], cfg['train_cfg'], cfg['test_cfg'])


def _blank_variables(det, batch):
    shapes = jax.eval_shape(det.init, {'params': jax.random.PRNGKey(0)},
                            batch)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def _test_batch(coco):
    """The first landscape image through the toy's test pipeline."""
    from dynamask_torch.data import build_dataset, collate
    cfg = toy_config(*coco)
    ds = build_dataset(dict(cfg.data['test']), dict(test_mode=True))
    return collate([ds[0]])


def _same_state(ma, oa, mb, ob):
    sa, sb = ma.state_dict(), mb.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert oa.steps == ob.steps
    qa, qb = oa.sgd.state_dict(), ob.sgd.state_dict()
    assert qa['param_groups'] == qb['param_groups']
    assert qa['state'].keys() == qb['state'].keys() and qa['state']
    for i in qa['state']:
        assert torch.equal(qa['state'][i]['momentum_buffer'],
                           qb['state'][i]['momentum_buffer']), i


def test_resume_is_bit_exact(runs):
    """One epoch, then a resume, ends where two epochs straight end: the
    model (BatchNorm statistics included), the momentum buffers, the step
    count and the epoch-2 rows (but for their times)."""
    root, (ma, oa), (mb, ob) = runs
    _same_state(ma, oa, mb, ob)
    assert oa.steps == 2 * STEPS
    strip = lambda r: {k: v for k, v in r.items() if k != 'time'}  # noqa
    ra = [strip(r) for r in rows(root / 'A') if r['epoch'] == 2]
    rb = [strip(r) for r in rows(root / 'B') if r['epoch'] == 2]
    assert len(ra) == STEPS and ra == rb
    # the epoch-1 checkpoints of the two runs are the same file content
    ca = torch.load(root / 'A' / 'epoch_1.pth', weights_only=True)
    cb = torch.load(root / 'B' / 'epoch_1.pth', weights_only=True)
    assert all(torch.equal(ca['state_dict'][k], cb['state_dict'][k])
               for k in ca['state_dict'])


def test_checkpoint_round_trip(runs, coco):
    """Mirrors tests/test_integration.py:test_checkpoint_roundtrip: epoch,
    step, CLASSES, momentum and ``steps`` come back into a differently
    seeded trainer; a work dir, its ``latest`` and the file resolve alike;
    ``load_params_only`` takes the weights and leaves the progress;
    ``init_detector`` reads the loop's checkpoint through the work dir."""
    from dynamask_torch.apis import init_detector, init_trainer
    from dynamask_torch.engine.checkpoint import (_resolve_ckpt_path,
                                                  load_checkpoint,
                                                  load_params_only)
    root, (ma, oa), _ = runs
    work = root / 'A'
    assert (work / 'latest').read_text() == 'epoch_2.pth'
    for path in (work, work / 'latest', work / 'epoch_2.pth'):
        assert _resolve_ckpt_path(str(path)) == str(work / 'epoch_2.pth')
    cfg = toy_config(*coco)
    mb, ob = init_trainer(cfg, steps_per_epoch=STEPS, device='cpu', seed=1)
    meta = load_checkpoint(str(work / 'latest'), mb, ob)
    assert meta['epoch'] == 2 and meta['step'] == 2 * STEPS
    assert meta['CLASSES'] == ['person', 'car']
    assert isinstance(meta['config'], str) and 'DynaMaskRoIHead' in \
        meta['config']
    _same_state(ma, oa, mb, ob)

    mc, oc = init_trainer(cfg, steps_per_epoch=STEPS, device='cpu', seed=1)
    assert load_params_only(str(work / 'epoch_1.pth'), mc)['epoch'] == 1
    ref = torch.load(work / 'epoch_1.pth', weights_only=True)['state_dict']
    assert all(torch.equal(mc.state_dict()[k], ref[k]) for k in ref)
    assert oc.steps == 0 and not oc.sgd.state_dict()['state']

    det = init_detector(cfg, str(work), device='cpu', seed=3)
    assert det.CLASSES == ('person', 'car')
    assert all(torch.equal(det.state_dict()[k], v)
               for k, v in ma.state_dict().items())


def test_lr_schedule_and_row_keys(runs, coco, jax_det):
    """Every train row's lr is the JAX ``step_lr_schedule`` at the step
    count after the step, over the cut epochs; the rows carry the JAX
    loop's keys: its own and the JAX train step's log."""
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     make_train_step, step_lr_schedule)
    from dynamask_torch.data import build_dataloader, build_dataset
    root, _, _ = runs
    cfg = toy_config(*coco)
    lr = cfg.lr_config
    schedule = step_lr_schedule(cfg.optimizer['lr'], STEPS,
                                decay_epochs=lr['step'],
                                warmup_iters=lr['warmup_iters'],
                                warmup_ratio=lr['warmup_ratio'])
    train = [r for r in rows(root / 'A') if r['mode'] == 'train']
    assert [(r['epoch'], r['iter'], r['step']) for r in train] == \
        [(1, 1, 1), (1, 2, 2), (2, 1, 3), (2, 2, 4)]
    for r in train:
        assert r['lr'] == pytest.approx(float(schedule(r['step'])),
                                        rel=1e-6), r['step']
    # the cut counts: over the loader's 4 batches the decay would wait
    uncut = step_lr_schedule(cfg.optimizer['lr'], 2 * STEPS,
                             decay_epochs=lr['step'],
                             warmup_iters=lr['warmup_iters'],
                             warmup_ratio=lr['warmup_ratio'])
    assert float(uncut(2)) > 5 * train[1]['lr']

    ds = build_dataset(dict(cfg.data['train']), dict(max_gts=8,
                                                     mask_crop_size=32))
    batch = next(iter(build_dataloader(ds, 2, workers_per_gpu=0)))
    batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()
             if k != 'img_id'}

    def step_log(b):
        v = jax_det.init({'params': jax.random.PRNGKey(0)}, b)
        tx = build_optimizer(v['params'], base_lr=cfg.optimizer['lr'])
        return make_train_step(jax_det, tx)(create_train_state(v, tx), b,
                                            jax.random.PRNGKey(1))[1]

    jax_keys = LOOP_KEYS | set(jax.eval_shape(step_log, batch))
    assert all(set(r) == jax_keys for r in train)


def test_port_checkpoint_into_jax(runs, coco, jax_det):
    """The loop's checkpoint through the JAX package's
    ``load_torch_state_dict`` + ``convert_torch_weights`` gives the port's
    ``simple_test`` outputs: the weights carry from the port to JAX."""
    from dynamask_tpu.engine.pretrained import (convert_torch_weights,
                                                load_torch_state_dict)
    root, (model, _), _ = runs
    batch = _test_batch(coco)
    keys = ('image', 'img_shape', 'scale_factor')
    jbatch = {k: jnp.asarray(batch[k].numpy()) for k in keys}
    blank = _blank_variables(jax_det, jbatch)
    params, stats, report = convert_torch_weights(
        load_torch_state_dict(str(root / 'A' / 'epoch_2.pth')),
        blank['params'], blank['batch_stats'])
    assert report['loaded'] and not report['skipped'] and \
        not report['mismatched']
    ref = jax.jit(lambda v, b: jax_det.apply(v, b, method='simple_test'))(
        {'params': params, 'batch_stats': stats}, jbatch)
    model.eval()
    try:
        got = model.simple_test({k: batch[k] for k in keys})
    finally:
        model.train()
    valid = np.asarray(ref['det_valid'][0]).astype(bool)
    assert valid.sum() >= 2
    np.testing.assert_array_equal(got['det_valid'][0].numpy().astype(bool),
                                  valid)
    np.testing.assert_array_equal(got['labels'][0].numpy()[valid],
                                  np.asarray(ref['labels'][0])[valid])
    for k in ('dets', 'mask_probs'):
        np.testing.assert_allclose(got[k][0].numpy()[valid],
                                   np.asarray(ref[k][0])[valid], rtol=0,
                                   atol=1e-4, err_msg=k)


def test_pretrained(runs, coco, jax_det, tmp_path, monkeypatch, capsys):
    """A local ``torchvision://resnet18`` file (found under a temporary
    ``TORCH_HOME``) loads the same backbone as the JAX ``apply_pretrained``;
    its classifier is skipped. An mmdet-named file (a loop checkpoint) maps
    one to one. A missing file, a URL or an ``open-mmlab://`` spec resolves
    to None on both sides and leaves the model as initialised."""
    from dynamask_tpu.engine.pretrained import (
        apply_pretrained as jax_apply,
        resolve_pretrained_path as jax_resolve)
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.engine.pretrained import (apply_pretrained,
                                                  resolve_pretrained_path)
    from dynamask_torch.models import build_detector
    root, (trained, _), _ = runs
    m = toy_config(*coco)
    build = lambda seed: build_detector(  # noqa: E731
        m.model, m.train_cfg, m.test_cfg, device='cpu', seed=seed)
    hub = tmp_path / 'hub' / 'checkpoints'
    hub.mkdir(parents=True)
    monkeypatch.setenv('TORCH_HOME', str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    tv = {k[len('backbone.'):]: (torch.randn(v.shape, generator=gen)
                                 if v.is_floating_point() else v)
          for k, v in build(3).state_dict().items()
          if k.startswith('backbone.')}
    tv['fc.weight'], tv['fc.bias'] = torch.randn(1000, 512), torch.zeros(1000)
    torch.save(tv, hub / 'resnet18-f37072fd.pth')
    spec = 'torchvision://resnet18'
    assert resolve_pretrained_path(spec) == jax_resolve(spec) == \
        str(hub / 'resnet18-f37072fd.pth')

    port = build(1)
    report = apply_pretrained(port, spec)
    assert sorted(report['skipped']) == ['fc.bias', 'fc.weight']
    assert not report['mismatched'] and len(report['loaded']) == len(tv) - 2
    blank = _blank_variables(jax_det, {k: jnp.asarray(v.numpy()) for k, v in
                                       _test_batch(coco).items()
                                       if k != 'img_id'})
    ref = build(2)
    load_jax_variables(ref, jax_apply(blank, spec))
    got, want = port.state_dict(), ref.state_dict()
    for k in got:
        if k.startswith('backbone.') and 'num_batches_tracked' not in k:
            assert torch.equal(got[k], want[k]), k

    mmdet = build(4)
    report = apply_pretrained(mmdet, str(root / 'A' / 'epoch_2.pth'))
    assert not report['skipped'] and not report['mismatched']
    assert all(torch.equal(mmdet.state_dict()[k], v)
               for k, v in trained.state_dict().items())
    # a tensor of another shape (an 80-class head) is reported, not loaded
    cls = 'roi_head.bbox_head.fc_cls.weight'
    before = mmdet.state_dict()[cls].clone()
    torch.save({'state_dict': {cls: torch.ones(81, before.shape[1])}},
               tmp_path / 'coco_head.pth')
    report = apply_pretrained(mmdet, str(tmp_path / 'coco_head.pth'))
    assert report['loaded'] == [] and len(report['mismatched']) == 1
    assert torch.equal(mmdet.state_dict()[cls], before)

    before = {k: v.clone() for k, v in port.state_dict().items()}
    for missing in ('torchvision://resnet50', 'https://host/r50.pth',
                    'open-mmlab://resnet50_caffe', str(tmp_path / 'no.pth')):
        assert resolve_pretrained_path(missing) is None
        assert jax_resolve(missing) is None
        capsys.readouterr()
        assert apply_pretrained(port, missing)['loaded'] == []
        assert 'training from scratch' in capsys.readouterr().out
    assert all(torch.equal(port.state_dict()[k], v)
               for k, v in before.items())


@pytest.mark.parametrize('wrapper', [
    dict(type='RepeatDataset', times=2),
    dict(type='ConcatDataset'),
    dict(type='ClassBalancedDataset', oversample_thr=0.9)],
    ids=['repeat', 'concat', 'class_balanced'])
def test_dataset_wrappers_equal(coco, wrapper):
    """``build_dataset`` builds each wrapper as the JAX package does: the
    same length, flags, index map and items, bit for bit (each sample's
    pipeline draws seeded by its index on both sides)."""
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.data import build_dataset
    inner = dict(toy_config(*coco).data['train'])
    cfg = dict(wrapper)
    if cfg['type'] == 'ConcatDataset':
        cfg['datasets'] = [inner, dict(inner, filter_empty_gt=False)]
    else:
        cfg['dataset'] = inner
    args = dict(max_gts=8, mask_crop_size=32)
    ref, got = jax_build(cfg, args), build_dataset(cfg, args)
    assert type(got).__name__ == type(ref).__name__ == cfg['type']
    for ds in (getattr(ref, 'datasets', None) or [ref.dataset]) + \
            (getattr(got, 'datasets', None) or [got.dataset]):
        pre = ds.pre_pipeline
        ds.pre_pipeline = (lambda idx, pre=pre: dict(
            pre(idx), _rng=np.random.RandomState(idx)))
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got.flags, ref.flags)
    assert got.flags.dtype == ref.flags.dtype
    if cfg['type'] == 'ClassBalancedDataset':
        np.testing.assert_array_equal(got.indices, ref.indices)
        assert len(got) > NUM_IMAGES     # some images repeat
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f'{i} {k}')


def test_validation_keeps_training_state(coco):
    """A validation round trip returns the COCO metrics and leaves the
    model as ``init_trainer`` made it: in training mode, the backbone's
    BatchNorms on (unchanged) running statistics, the MSM's on batch
    statistics, the frozen stages without gradients."""
    from dynamask_torch.apis import get_root_logger, init_trainer
    from dynamask_torch.apis.train import _run_validation
    cfg = toy_config(*coco)
    model, _ = init_trainer(cfg, steps_per_epoch=STEPS, device='cpu')
    bb = model.backbone
    stats = {k: v.clone() for k, v in bb.state_dict().items()
             if 'running' in k}
    frozen = [p for m in bb.frozen_modules() for p in m.parameters()]
    metrics = _run_validation(cfg, model, cfg.evaluation, get_root_logger())
    assert {'bbox_mAP', 'segm_mAP'} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert model.training and model.roi_head.training
    bns = [m for m in bb.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and not any(m.training for m in bns)
    msm = model.roi_head.mask_predictor
    assert msm.bn1.training and msm.bn2.training
    assert frozen and not any(p.requires_grad for p in frozen)
    assert all(torch.equal(bb.state_dict()[k], v) for k, v in stats.items())


def _write_cfg(path, cfg):
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return str(path)


def test_cli(runs, coco, tmp_path, monkeypatch, capsys):
    """``python -m dynamask_torch.tools.train cfg --device cpu`` in a
    subprocess, with 2 loader workers and ``--load-from`` the straight
    run's checkpoint: exits 0, writes ``epoch_1.pth``, ``latest``, train
    rows that start the progress afresh and a val row. ``--devices 2`` and
    ``--launcher pytorch`` exit 2 naming the DDP item; without a GPU the
    default device exits 1; a ``bf16`` config trains its epoch in bf16,
    logs the mixed-precision line and saves fp32 weights; a batch no group
    can fill raises."""
    from dynamask_torch.apis import train_detector
    from dynamask_torch.tools.train import main
    root, _, _ = runs
    cfg = toy_config(*coco, workers=2).to_dict()
    path = _write_cfg(tmp_path / 'cfg.py', cfg)
    work = tmp_path / 'work'
    proc = subprocess.run(
        [sys.executable, '-m', 'dynamask_torch.tools.train', path,
         '--device', 'cpu', '--work-dir', str(work),
         '--max-steps-per-epoch', '1', '--load-from',
         str(root / 'A' / 'epoch_2.pth'), '--options', 'total_epochs=1'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (work / 'epoch_1.pth').is_file()
    assert (work / 'latest').read_text() == 'epoch_1.pth'
    got = rows(work)
    assert [(r['mode'], r['epoch']) for r in got] == [('train', 1),
                                                      ('val', 1)]
    assert got[0]['step'] == 1 and np.isfinite(got[1]['bbox_mAP'])
    assert 'loaded weights from' in proc.stderr

    for flags in (['--devices', '2'], ['--launcher', 'pytorch']):
        assert main([path, *flags]) == 2
        err = capsys.readouterr().err
        assert 'DDP' in err and 'ROADMAP' in err
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert main([path]) == 1
    assert 'CUDA' in capsys.readouterr().err
    from dynamask_torch.utils import Config
    bf16 = tmp_path / 'bf16'
    model, _ = train_detector(
        Config(dict(cfg, bf16=True, total_epochs=1,
                    data=dict(cfg['data'], workers_per_gpu=0))),
        work_dir=str(bf16), max_steps_per_epoch=1, device='cpu',
        validate=False)
    text = ''.join(open(f).read() for f in glob.glob(str(bf16 / '*.log')))
    assert 'mixed precision: bf16 compute, fp32 master weights' in text
    got = rows(bf16)
    assert [r['mode'] for r in got] == ['train']
    assert np.isfinite(got[0]['loss'])
    sd = torch.load(bf16 / 'epoch_1.pth', weights_only=True)['state_dict']
    assert all(v.dtype == torch.float32 for v in sd.values()
               if v.is_floating_point())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # a batch larger than each orientation group: no step can form
    big = dict(cfg, data=dict(cfg['data'], samples_per_gpu=NUM_IMAGES))
    with pytest.raises(ValueError, match='samples_per_gpu'):
        train_detector(Config(big), work_dir=str(tmp_path / 'big'),
                       device='cpu')


def test_init_draws_from_the_jax_initialisers(jax_det, coco):
    """The port's seeded initialisation draws each tensor from the JAX
    package's initialiser: the same constant tensors (a residual block's
    last BatchNorm scale at 0, ``zero_init_residual``; the other scales at
    1; zero biases, offsets and statistics) and, for every random tensor
    of at least 1000 entries, the same spread (std within 10%, the JAX
    draw's own sampling error is under 5%) and a mean within 0.1 std of
    the JAX one. The MSM takes flax's default (LeCun normal over fan-in,
    truncated), which its JAX module leaves in place."""
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    m = toy_config(*coco)
    build = lambda seed: build_detector(  # noqa: E731
        m.model, m.train_cfg, m.test_cfg, device='cpu', seed=seed)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _test_batch(coco).items()
             if k != 'img_id'}
    ref = build(1)
    load_jax_variables(ref, jax.device_get(fast_jit(jax_det.init)(
        {'params': jax.random.PRNGKey(0)}, batch)))
    want, got = ref.state_dict(), build(0).state_dict()
    zero_scales = [k for k in want if k.startswith('backbone.layer') and
                   k.endswith('.weight') and not want[k].any()]
    assert len(zero_scales) == 8    # bn2 of ResNet-18's eight blocks
    checked = 0
    for k, w in want.items():
        g = got[k].double()
        w = w.double()
        if w.numel() < 1000 or (w == w.flatten()[0]).all():
            if (w == w.flatten()[0]).all():   # a constant tensor
                assert torch.equal(g, w), k
            continue
        assert abs(g.std() / w.std() - 1) < 0.1, k
        assert abs(g.mean() - w.mean()) < 0.1 * w.std(), k
        checked += 1
    assert checked >= 40
    assert all(not got[k].any() for k in zero_scales)

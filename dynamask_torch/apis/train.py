"""Training entry points (port of ``dynamask_tpu/apis/train.py``):
``train_detector``, the epoch loop of the config's recipe with text and
json logs, checkpoints, resume and validation, on one device or on each
rank of a process group; ``init_trainer`` (the
detector and its optimizer from a config) and ``train_steps`` (optimizer
steps on given batches: a ``build_dataloader`` batch, or the seeded
synthetic batch here, in the JAX package's training batch contract).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import os.path as osp
import random
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data import (build_dataloader, build_dataset, dataset_spec,
                    rasterize_semantic)
from ..engine.checkpoint import (load_checkpoint, load_params_only,
                                 save_checkpoint)
from ..engine.optimizer import DetectorSGD, build_optimizer
from ..engine.pretrained import apply_pretrained
from ..engine.train import make_train_step
from ..engine.train_state import active_group
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.env import collect_env
from .inference import init_detector
from .test import multi_device_test, single_device_test



def init_trainer(config: Union[str, Config], *, steps_per_epoch: int,
                 device=None, seed: int = 0, init_std: Optional[float] = None
                 ) -> Tuple[torch.nn.Module, DetectorSGD]:
    """The config's detector in training mode (frozen stages frozen,
    backbone BatchNorms on running statistics), initialised from ``seed``
    as the JAX package initialises it (or, given ``init_std``, N(0,
    ``init_std``) weights as :func:`init_detector` draws them), and its
    optimizer (``optimizer``, ``optimizer_config``, ``lr_config``). The lr
    steps down at the epochs of ``lr_config.step``, counted in
    ``steps_per_epoch`` optimizer steps (the JAX trainer takes it from its
    loader's length). Every file trains with JAX's SGD recipe, CornerNet's
    ``Adam`` too (``engine.optimizer.build_optimizer``, 3br)."""
    model = init_detector(config, device=device, seed=seed,
                          init_std=init_std)
    cfg = model.cfg
    opt = build_optimizer(model, cfg.optimizer, cfg.get('optimizer_config'),
                          cfg.get('lr_config'),
                          steps_per_epoch=steps_per_epoch)
    return model.train(), opt


def train_steps(model: torch.nn.Module, optimizer: DetectorSGD,
                batches: Iterable[Dict[str, torch.Tensor]],
                generator: Optional[torch.Generator] = None,
                compute_dtype: Optional[torch.dtype] = None, group=None
                ) -> List[Dict[str, torch.Tensor]]:
    """One optimizer step per batch; returns each step's log (losses,
    ``loss``, ``grad_norm``). Random draws come from ``generator``;
    ``compute_dtype`` and ``group`` as :func:`engine.train.make_train_step`
    (bf16 compute on fp32 master weights, or None for fp32; the
    data-parallel step over a process group, each rank on its own
    batches)."""
    step = make_train_step(model, optimizer, compute_dtype, group)
    dev = model.device
    return [step({k: v.to(dev) for k, v in b.items()}, generator=generator)
            for b in batches]


def step_generator(seed: int, epoch: int, it: int,
                   device: torch.device, rank: int = 0) -> torch.Generator:
    """The generator of one loop step's draws (sampler priorities, Gumbel
    uniforms), seeded from ``(seed, epoch, it)``: the counterpart of
    ``fold_in(train_rng, epoch * 10**6 + it)``
    (``dynamask_tpu/apis/train.py:201``), so a resumed run draws what the
    straight run drew. A data-parallel rank other than 0 draws from
    ``(seed, epoch, it, rank)``, independently, as JAX's DDP step folds in
    the device's index (``engine/train_state.py:186``); rank 0 draws what
    one device draws."""
    key = (epoch * 10 ** 6 + it,) + ((rank,) if rank else ())
    ss = np.random.SeedSequence(seed, spawn_key=key)
    return torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0]))


def get_root_logger(log_file: Optional[str] = None,
                    level: int = logging.INFO) -> logging.Logger:
    """The port's logger (reference mmdet/utils/logger.py): one stream
    handler, and a file handler for ``log_file`` unless it has one."""
    logger = logging.getLogger('dynamask_torch')
    logger.setLevel(level)
    fmt = logging.Formatter('%(asctime)s - %(name)s - %(levelname)s - '
                            '%(message)s')
    handlers = [logging.StreamHandler()] if not logger.handlers else []
    if log_file and not any(getattr(h, 'baseFilename', None) ==
                            osp.abspath(log_file) for h in logger.handlers):
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def set_random_seed(seed: int, deterministic: bool = False) -> None:
    """Seed Python's, NumPy's and PyTorch's global generators (reference
    mmdet/apis/train.py:set_random_seed; the port's own draws come from
    explicit generators); ``deterministic`` also makes cuDNN pick
    deterministic algorithms."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def _run_logs(work_dir: str):
    """The run's text log ``{timestamp}.log`` (through the root logger) and
    json log ``{timestamp}.log.json`` in ``work_dir``; both closed at the
    end."""
    stamp = time.strftime('%Y%m%d_%H%M%S')
    log_file = osp.abspath(osp.join(work_dir, f'{stamp}.log'))
    logger = get_root_logger(log_file)
    try:
        with open(osp.join(work_dir, f'{stamp}.log.json'), 'a') as json_log:
            yield logger, json_log
    finally:
        for h in [h for h in logger.handlers
                  if getattr(h, 'baseFilename', None) == log_file]:
            logger.removeHandler(h)
            h.close()


@contextlib.contextmanager
def _rank_logs(work_dir: str, rank: int):
    """Rank 0's :func:`_run_logs`; another rank writes no file, and its
    logger (a child of the root logger) passes on warnings only."""
    if rank == 0:
        with _run_logs(work_dir) as logs:
            yield logs
        return
    logger = logging.getLogger('dynamask_torch').getChild(f'rank{rank}')
    logger.setLevel(logging.WARNING)
    yield logger, None


def _write_row(json_log, row: dict) -> None:
    """One json log row (none on a rank without the log)."""
    if json_log is None:
        return
    json_log.write(json.dumps(row) + '\n')
    json_log.flush()


def train_detector(cfg: Config, work_dir: Optional[str] = None,
                   resume_from: Optional[str] = None,
                   load_from: Optional[str] = None, seed: int = 0,
                   max_steps_per_epoch: Optional[int] = None,
                   device=None, validate: bool = True
                   ) -> Tuple[torch.nn.Module, DetectorSGD]:
    """Train per the config's recipe (port of ``train_detector``,
    ``dynamask_tpu/apis/train.py:58-238``) on one device: ``device``,
    default ``cuda``. Returns the model and its optimizer.

    Where a process group is up (``engine.init_group``; the train CLI's
    ``--devices N`` and ``--launcher pytorch``), each rank runs this with
    its own ``device`` and the loop is data-parallel, as JAX's is over
    its devices: each rank loads its shard of each global batch
    (``samples_per_gpu`` images a rank, ``build_dataloader(num_shards=,
    shard_index=)``), every rank builds the same model from ``seed`` and
    reads the same ``resume_from`` / ``load_from``, each step is the DDP
    step (``make_train_step(group=)``: one fused all-reduce of the
    gradients, the log and the running statistics) on the rank's own draws
    (:func:`step_generator`), only rank 0 writes the logs and checkpoints
    (all ranks wait for each save), and validation runs
    :func:`multi_device_test`, rank 0 evaluating and logging the row.

    The train set and its loader (the config's ``samples_per_gpu`` and
    ``workers_per_gpu``; workers kept across epochs), epochs of
    ``min(len(loader), max_steps_per_epoch)`` steps whose length the lr
    schedule counts in, the detector from ``seed`` (then ``pretrained``, a
    local file, unless resuming or loading), ``resume_from`` (model,
    optimizer, epoch) or ``load_from`` (weights only). Each epoch: the
    sampler's epoch, the steps (each one's draws from
    :func:`step_generator`), a log row every ``log_config.interval`` steps
    and at the epoch's last, a checkpoint every
    ``checkpoint_config.interval`` epochs, and unless ``validate`` is
    False validation every ``evaluation.interval`` epochs (a failure is
    logged, as in the JAX loop; under a process group it raises). Text log ``{timestamp}.log`` and json rows
    ``{timestamp}.log.json`` in ``work_dir``; each epoch's timings go to the
    logger as the record's ``epoch_timing``. A ``bf16 = True`` or an
    mmdet-style ``fp16 = dict(...)`` config key trains in bf16 on fp32
    master weights (``dynamask_tpu/apis/train.py:175-177``; bf16 needs no
    loss scale, so the fp16 options are not read); checkpoints and
    validation stay fp32."""
    dev = resolve_device(device)
    group = active_group()
    rank, world = ((0, 1) if group is None else
                   (dist.get_rank(group), dist.get_world_size(group)))
    compute_dtype = (torch.bfloat16 if cfg.get('bf16') or
                     cfg.get('fp16') is not None else None)
    work_dir = work_dir or cfg.get('work_dir') or './work_dirs/default'
    os.makedirs(work_dir, exist_ok=True)
    with _rank_logs(work_dir, rank) as (logger, json_log):
        env = '\n'.join(f'{k}: {v}' for k, v in collect_env().items())
        logger.info('Environment info:\n' + '-' * 60 + f'\n{env}\n' +
                    '-' * 60)
        logger.info(f'device: {dev}' + ('' if group is None else
                    f'; {world} data-parallel rank(s) over '
                    f'{dist.get_backend(group)}'))
        set_random_seed(seed)
        data = cfg.data
        dataset = build_dataset(dict(data['train']), default_args=dict(
            max_gts=data.get('max_gts', 100),
            mask_crop_size=data.get('mask_crop_size', 128)))
        loader = build_dataloader(dataset, data['samples_per_gpu'],
                                  workers_per_gpu=data.get('workers_per_gpu',
                                                           4), seed=seed,
                                  num_shards=world, shard_index=rank)
        steps_per_epoch = len(loader)
        if max_steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
        logger.info(f'{len(dataset)} images, {steps_per_epoch} steps/epoch')
        if steps_per_epoch == 0:
            raise ValueError(
                f'the global batch (samples_per_gpu='
                f'{data["samples_per_gpu"]} x {world} device(s)) exceeds '
                f'the dataset ({len(dataset)} images) - no full batch can '
                f'form. Reduce samples_per_gpu or the number of devices.')
        model, optimizer = init_trainer(cfg, steps_per_epoch=steps_per_epoch,
                                        device=dev, seed=seed)
        logger.info(f'model built: '
                    f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f}'
                    f'M params')
        if compute_dtype is not None:
            logger.info('mixed precision: bf16 compute, fp32 master weights')
        pretrained = (cfg.model or {}).get('pretrained')
        if pretrained and not (resume_from or load_from):
            apply_pretrained(model, pretrained, logger)
        start_epoch = 0
        if resume_from:
            t = time.perf_counter()
            start_epoch = load_checkpoint(resume_from, model,
                                          optimizer).get('epoch', 0)
            logger.info(f'resumed from {resume_from} at epoch {start_epoch}',
                        extra={'load_s': time.perf_counter() - t})
        elif load_from:
            load_params_only(load_from, model)
            logger.info(f'loaded weights from {load_from}')

        total_epochs = cfg.get('total_epochs', 12)
        log_interval = (cfg.get('log_config') or {}).get('interval', 50)
        ckpt_interval = (cfg.get('checkpoint_config') or {}).get('interval',
                                                                 1)
        eval_cfg = cfg.get('evaluation') or {}
        # --no-validate (reference root train.py) turns the EvalHook off
        eval_interval = eval_cfg.get('interval', 0) if validate else 0
        meta = {'CLASSES': list(getattr(dataset, 'CLASSES', [])),
                'config': cfg.dump()}
        for epoch in range(start_epoch, total_epochs):
            loader.batch_sampler.set_epoch(epoch)
            timing = dict(epoch=epoch + 1, first_batch_s=0.0, data_s=0.0)
            t_start = time.time()
            batches = iter(loader)
            for it in range(steps_per_epoch):
                t = time.perf_counter()
                batch = next(batches)
                timing['data_s' if it else 'first_batch_s'] += \
                    time.perf_counter() - t
                log, = train_steps(model, optimizer, [batch],
                                   step_generator(seed, epoch, it, dev, rank),
                                   compute_dtype, group)
                if (it + 1) % log_interval == 0 or it + 1 == steps_per_epoch:
                    log = {k: float(v) for k, v in log.items()}
                    step = optimizer.steps
                    lr = float(optimizer.lr_schedule(step))
                    dt = (time.time() - t_start) / (it + 1)
                    msg = ', '.join(f'{k}: {v:.4f}'
                                    for k, v in sorted(log.items()))
                    logger.info(f'Epoch [{epoch + 1}][{it + 1}/'
                                f'{steps_per_epoch}] lr: {lr:.2e}, '
                                f'time: {dt:.3f}s, {msg}')
                    _write_row(json_log, {
                        'mode': 'train', 'epoch': epoch + 1, 'iter': it + 1,
                        'step': step, 'lr': lr, 'time': dt, **log})
            timing['train_s'] = time.time() - t_start
            if (epoch + 1) % ckpt_interval == 0:
                t = time.perf_counter()
                if rank == 0:
                    path = save_checkpoint(work_dir, model, optimizer,
                                           epoch + 1, meta)
                if group is not None:
                    dist.barrier(group)
                timing['save_s'] = time.perf_counter() - t
                if rank == 0:
                    timing['checkpoint_bytes'] = os.path.getsize(path)
                    logger.info(f'checkpoint saved: {path}')
            if eval_interval and (epoch + 1) % eval_interval == 0:
                # the EvalHook (reference core/evaluation/eval_hooks.py:
                # 7-80): the val split through the test loop and evaluate
                t = time.perf_counter()
                try:
                    metrics = _run_validation(cfg, model, eval_cfg, logger,
                                              group)
                except Exception:
                    # validation never stops training on one device; a
                    # rank that failed alone would leave the others in
                    # multi_device_test's gather, so under a group it
                    # fails the run (the launcher then ends the others)
                    if group is not None:
                        raise
                    logger.warning('validation failed', exc_info=True)
                else:
                    if metrics is not None:
                        _write_row(json_log, {'mode': 'val',
                                              'epoch': epoch + 1, **metrics})
                timing['val_s'] = time.perf_counter() - t
            logger.info(f'epoch {epoch + 1} timings: ' + ', '.join(
                f'{k} {v:.3f}' for k, v in timing.items() if k != 'epoch'),
                extra={'epoch_timing': timing})
    return model, optimizer


def _run_validation(cfg: Config, model: torch.nn.Module, eval_cfg: dict,
                    logger: logging.Logger, group=None
                    ) -> Optional[Dict[str, float]]:
    """The val (else test) split through :func:`single_device_test` on the
    live model (``evaluation.max_images``; the config's loader workers),
    or with a process ``group`` through :func:`multi_device_test` on every
    rank, then ``evaluate`` with ``evaluation.metric`` and ``classwise``
    (rank 0 alone: the others return None). The model goes back to its
    training state: ``train()`` keeps ``norm_eval`` BatchNorms on running
    statistics, and ``requires_grad`` is not touched."""
    val_cfg = dict(cfg.data.get('val') or cfg.data.get('test'))
    dataset = build_dataset(val_cfg, default_args=dict(test_mode=True))
    loop = (single_device_test if group is None else
            functools.partial(multi_device_test, group=group))
    model.eval()
    try:
        results = loop(model, dataset,
                       max_images=eval_cfg.get('max_images'),
                       workers_per_gpu=cfg.data.get('workers_per_gpu', 4),
                       progress=False)
    finally:
        model.train()
    if group is not None and dist.get_rank(group) != 0:
        return None
    metric = eval_cfg.get('metric', ['bbox', 'segm'])
    metrics = dataset.evaluate(
        results, metric=[metric] if isinstance(metric, str) else metric,
        classwise=eval_cfg.get('classwise', False))
    where = ('' if group is None else f', multi_device_test over '
             f'{dist.get_world_size(group)} rank(s)')
    logger.info(f'validation ({len(results)} images{where}): ' + ', '.join(
        f'{k}: {v:.4f}' for k, v in metrics.items()))
    return {k: float(v) for k, v in metrics.items()}


def semantic_seg_shape(model: torch.nn.Module) -> Optional[Tuple[int, int]]:
    """(stride, classes) of the ``gt_semantic_seg`` a model's semantic
    branch reads (HTC's ``FusedSemanticHead``), or None without one."""
    head = getattr(getattr(model, 'roi_head', None), 'semantic_head', None)
    if head is None:
        return None
    return model.roi_head.semantic_out_stride, head.num_classes


def config_shapes(config: Union[str, Config]
                  ) -> Tuple[Tuple[int, int], int, Tuple[int, int]]:
    """The shapes ``config`` runs at, from what it states: the first
    (landscape) canvas of its test set, where one image is inferred, and
    a training step's images (``data.samples_per_gpu``) with the first
    canvas of its train set."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    data = config.data
    return (dataset_spec(data.test)[1][0], data.samples_per_gpu,
            dataset_spec(data.train)[1][0])


def synthetic_batch(seed: int, b: int = 1, h: int = 128, w: int = 128,
                    num_gts: int = 4, max_gts: Optional[int] = None,
                    crop_size: int = 32, num_classes: int = 80,
                    device=None, with_semantic: bool = False,
                    semantic_seg: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A padded training batch from ``seed``: N(0, 1) NHWC images, boxes of
    10-40% of the image side, elliptic mask crops over windows 2 px larger
    than the boxes; ``num_gts`` valid GTs in ``max_gts`` slots. With
    ``with_semantic`` (a RefineMask step: ``roi_head.with_semantic``), also
    ``gt_semantic`` (b, h // 4, w // 4): the ellipses as 32-gons in image
    coordinates through the data pipeline's own rasteriser
    (``data.rasterize_semantic``). With ``semantic_seg = (stride,
    classes)`` (an HTC step: :func:`semantic_seg_shape`), also
    ``gt_semantic_seg`` (b, h // stride, w // stride) int64: uniform labels
    in [0, classes), a tenth of the pixels 255 (ignored), drawn after
    everything else so the other keys do not change."""
    r = np.random.RandomState(seed)
    g = max_gts or num_gts
    side = min(h, w)
    cx, cy = r.uniform(0.1, 0.9, (2, b, g)) * np.asarray([[[w]], [[h]]])
    bw, bh = r.uniform(0.1, 0.4, (2, b, g)) * side
    boxes = np.stack([np.clip(cx - bw / 2, 0, w), np.clip(cy - bh / 2, 0, h),
                      np.clip(cx + bw / 2, 0, w), np.clip(cy + bh / 2, 0, h)],
                     -1).astype(np.float32)
    valid = np.broadcast_to(np.arange(g) < num_gts, (b, g)).copy()
    boxes[~valid] = 0.0
    grid = (np.arange(crop_size) + 0.5) / crop_size - 0.5
    ry, rx = r.uniform(0.25, 0.5, (2, b, g, 1, 1))
    crops = ((grid[:, None] / ry) ** 2 + (grid[None, :] / rx) ** 2 <= 1.0)
    batch = {
        'image': r.randn(b, h, w, 3).astype(np.float32),
        'img_shape': np.tile([[h, w]], (b, 1)).astype(np.float32),
        'gt_boxes': boxes,
        'gt_labels': r.randint(0, num_classes, (b, g)).astype(np.int64),
        'gt_valid': valid,
        'gt_crops': (crops & valid[..., None, None]).astype(np.uint8),
        'gt_windows': boxes + np.asarray([-2, -2, 2, 2], np.float32),
    }
    if with_semantic:
        win = batch['gt_windows']
        t = np.linspace(0, 2 * np.pi, 32, endpoint=False)
        ctr = (win[..., :2] + win[..., 2:]) / 2                 # (b, g, 2)
        axes = (win[..., 2:] - win[..., :2]) * np.stack(
            [rx[..., 0, 0], ry[..., 0, 0]], -1)
        polys = ctr[..., None, :] + axes[..., None, :] * np.stack(
            [np.cos(t), np.sin(t)], -1)                       # (b, g, 32, 2)
        batch['gt_semantic'] = np.stack([rasterize_semantic(
            [[polys[i, j].reshape(-1)] for j in range(num_gts)], (h, w))
            for i in range(b)])
    if semantic_seg:
        stride, classes = semantic_seg
        seg = r.randint(0, classes, (b, h // stride, w // stride))
        seg[r.uniform(size=seg.shape) < 0.1] = 255
        batch['gt_semantic_seg'] = seg.astype(np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}

"""Data parallelism on the CPU: the port's DDP step, sharded loaders and
``multi_device_test`` (two ranks spawned over gloo with a file store, one
thread and no loader workers each; ``tests/torch_ddp_ranks.py``) against
the JAX package's ``jit_train_step_ddp`` over a 2-device mesh, its
``GroupedBatchSampler`` and its ``multi_device_test``, at the toy DynaMask
config (ResNet-18, 32-channel FPN, 8 classes).

The DDP step: ``demo_batch(0, b=2, h=64, w=64, g=3, s=16)``, one image a
rank, the same sampler priorities and Gumbel uniforms on both ranks and
patched into JAX while it traces (``test_torch_port_train_slice.
jax_draws``), from the train slice's randomised variables. Tolerances:
the log scalars 1e-4 relative, ``grad_norm`` 1e-4 relative, each updated
parameter 1e-3 relative L2 (the train slice's rule: fp32 sums in other
orders through a ResNet, an FPN, RoIAlign and the DCN cascade), the
averaged BatchNorm statistics 1e-5 relative L2. The two ranks' states must
be equal bit for bit, and at world size 1 the DDP step must be the step
without a group bit for bit.

``multi_device_test`` over a 5-image set (an odd count: each orientation
group's last batch wraps around): every rank's results equal
``single_device_test``'s in order and content, and JAX's
``multi_device_test`` over 2 devices within the eval slice's tolerances.
``--launcher pytorch``'s group comes from torchrun's environment.
"""

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_port_modules import _toy_variables  # noqa: E402
from test_torch_port_train_slice import jax_draws, leaves, rel_l2  # noqa
from torch_ddp_ranks import ddp_step, multi_test, run_ranks  # noqa: E402

LR = 0.01
LOG_RTOL = 1e-4
PARAM_RL2 = 1e-3
STATS_RL2 = 1e-5
N_ANCHORS = 3 * sum((64 // s) ** 2 for s in (4, 8, 16, 32, 64))


def toy_noise(seed=12):
    """The train slice's draws for one image: RPN and RoI sampler
    priorities and the Gumbel uniforms."""
    rng = np.random.RandomState(seed)
    return {'rpn': rng.uniform(size=(1, N_ANCHORS)).astype(np.float32),
            'rcnn': rng.uniform(size=(1, 3 + 32)).astype(np.float32),
            'gumbel': rng.uniform(1e-4, 1 - 1e-4, (8, 4)).astype(np.float32)}


def numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


@pytest.fixture(scope='module')
def toy():
    """The JAX toy, its randomised variables and the port's twin."""
    from test_dynamask import dynamask_toy_cfg
    from dynamask_tpu.models import build_detector as jax_build
    from dynamask_torch.engine import load_jax_variables
    from dynamask_torch.models import build_detector
    cfgs = dynamask_toy_cfg()
    variables = _toy_variables()
    port = build_detector(*cfgs, device='cpu')
    load_jax_variables(port, variables)
    return jax_build(*cfgs), variables, port, cfgs


def as_jax_variables(state, like):
    """A port ``state_dict`` in the JAX variable tree (the production
    weight importer)."""
    from dynamask_tpu.engine.pretrained import convert_torch_weights
    zeros = jax.tree_util.tree_map(np.zeros_like, like)
    params, stats, report = convert_torch_weights(
        dict(state), zeros['params'], zeros['batch_stats'], scope='mmdet')
    assert not report['mismatched'], report['mismatched']
    return {'params': params, 'batch_stats': stats}


@pytest.fixture(scope='module')
def ddp_run(toy, tmp_path_factory):
    """Two port ranks and JAX's DDP step over 2 devices, one step each on
    the same batch, state and draws."""
    from test_models import demo_batch
    from dynamask_tpu.engine import (build_optimizer, create_train_state,
                                     data_parallel_mesh, jit_train_step_ddp,
                                     step_lr_schedule)
    det, variables, port, cfgs = toy
    batch = {k: np.array(v) for k, v in demo_batch(
        0, b=2, h=64, w=64, g=3, s=16).items()}
    noise = toy_noise()
    ranks = run_ranks(ddp_step, 2, str(tmp_path_factory.mktemp('ddp')),
                      cfgs, numpy_state(port.train()), batch, noise, LR)
    tx = build_optimizer(
        variables['params'], LR, 0.9, 1e-4, 35.0,
        step_lr_schedule(LR, 10, warmup_iters=0),
        frozen_backbone_prefixes=det.backbone.frozen_param_paths())
    # a copy: the step donates its state
    state = create_train_state(
        jax.tree_util.tree_map(jnp.array, variables), tx)
    step, place = jit_train_step_ddp(det, tx,
                                     data_parallel_mesh(jax.devices()[:2]))
    state, jbatch, rng = place(state, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, jax.random.PRNGKey(0))
    with jax_draws(noise):
        state, log = step(state, jbatch, rng)
    ref = jax.device_get({'params': state.params,
                          'batch_stats': state.batch_stats})
    return ranks, jax.device_get(log), ref, variables


def test_ddp_step_ranks_agree(ddp_run):
    """One all-reduce a step on each rank; the replicated state is the same
    bit for bit on both after the step, and so is the averaged log."""
    ranks = ddp_run[0]
    assert [r['calls'] for r in ranks] == [1, 1]
    assert ranks[0]['nbytes'] == ranks[1]['nbytes'] > 0
    a, b = (r['state'] for r in ranks)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ranks[0]['log']:
        np.testing.assert_array_equal(ranks[0]['log'][k],
                                      ranks[1]['log'][k], err_msg=k)


def test_ddp_step_log_against_jax(ddp_run):
    """The averaged losses and the averaged gradients' norm."""
    ranks, jax_log, _, _ = ddp_run
    got = ranks[0]['log']
    keys = {k for k in jax_log if 'loss' in k or k == 'acc'}
    assert keys == {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                    'loss_bbox', 'acc', 'loss_masks', 'loss_flops', 'loss'}
    for k in sorted(keys) + ['grad_norm']:
        np.testing.assert_allclose(got[k], jax_log[k], rtol=LOG_RTOL,
                                   atol=1e-6, err_msg=k)
    assert jax_log['loss_bbox'] > 0 and jax_log['loss_masks'] > 0


def test_ddp_step_state_against_jax(ddp_run):
    """Every updated parameter, and the running statistics averaged over
    the ranks (the MSM's, on batch statistics; the frozen backbone's
    unchanged)."""
    ranks, _, ref, variables = ddp_run
    got = as_jax_variables(ranks[0]['state'], variables)
    before = leaves(variables['params'])
    p_got, p_ref = leaves(got['params']), leaves(ref['params'])
    assert p_got.keys() == p_ref.keys()
    moved = 0
    for k in p_ref:
        if not np.abs(p_ref[k]).max():
            np.testing.assert_array_equal(p_got[k], p_ref[k], k)
            continue
        assert rel_l2(p_got[k], p_ref[k]) < PARAM_RL2, k
        moved += not np.array_equal(p_ref[k], before[k])
    assert moved > 100
    s_got, s_ref = leaves(got['batch_stats']), leaves(ref['batch_stats'])
    s_before = leaves(variables['batch_stats'])
    assert s_got.keys() == s_ref.keys()
    changed = [k for k in s_ref if not np.array_equal(s_ref[k],
                                                      s_before[k])]
    assert changed and all('mask_predictor' in k for k in changed)
    for k in s_ref:
        assert rel_l2(s_got[k], s_ref[k]) < STATS_RL2, k


def test_world_size_one_is_the_plain_step(toy, tmp_path):
    """In process, a group of one (gloo): the DDP step's log, parameters,
    gradients and statistics equal ``make_train_step``'s bit for bit. At
    one thread: the CPU's convolution backward sums its threads' parts in
    a varying order, so two plain steps part in the last bits at two."""
    from test_models import demo_batch
    from dynamask_torch.engine import (DetectorSGD, active_group,
                                       destroy_group, init_group,
                                       make_train_step, step_lr_schedule)
    port = toy[2]
    batch = {k: torch.from_numpy(np.array(v)) for k, v in demo_batch(
        0, b=1, h=64, w=64, g=3, s=16).items()}
    noise = {k: torch.from_numpy(v) for k, v in toy_noise().items()}
    models = [copy.deepcopy(port).train() for _ in range(2)]
    opts = [DetectorSGD(m, LR, 0.9, 1e-4, 35.0,
                        step_lr_schedule(LR, 10, warmup_iters=0))
            for m in models]
    plain = make_train_step(models[0], opts[0])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    init_group('cpu', rank=0, world_size=1,
               init_method=f'file://{tmp_path}/store')
    try:
        ddp = make_train_step(models[1], opts[1], group=active_group())
        logs = [plain(batch, noise), ddp(batch, noise)]
    finally:
        destroy_group()
        torch.set_num_threads(threads)
    assert plain.reduce is None and ddp.reduce.calls == 1
    assert logs[0].keys() == logs[1].keys()
    for k in logs[0]:
        assert torch.equal(logs[0][k], logs[1][k]), k
    for (k, p), (_, q) in zip(*(list(m.named_parameters())
                                for m in models)):
        assert torch.equal(p, q), k
        assert (p.grad is None) == (q.grad is None), k
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), k
    for (k, u), (_, v) in zip(*(list(m.named_buffers()) for m in models)):
        assert torch.equal(u, v), k


@pytest.mark.parametrize('drop_last', [True, False])
@pytest.mark.parametrize('samples_per_gpu', [1, 2])
def test_sharded_loaders(samples_per_gpu, drop_last):
    """Each rank's batches of indices from ``build_dataloader(num_shards=2,
    shard_index=r)``, shuffled and in order, over two epochs, are JAX's
    sampler's with the same arguments; the ranks' lengths are equal."""
    from dynamask_tpu.data.loader import GroupedBatchSampler
    from dynamask_torch.data import build_dataloader

    class Flags:       # 7 landscape and 4 portrait images
        flags = np.asarray([0, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0])

        def __len__(self):
            return len(self.flags)

    for shuffle in (True, False):
        lengths = set()
        for r in range(2):
            loader = build_dataloader(Flags(), samples_per_gpu,
                                      workers_per_gpu=0, shuffle=shuffle,
                                      seed=3, drop_last=drop_last,
                                      num_shards=2, shard_index=r)
            ref = GroupedBatchSampler(Flags.flags, samples_per_gpu,
                                      shuffle=shuffle, seed=3, num_shards=2,
                                      shard_index=r, drop_last=drop_last)
            assert len(loader) == len(ref)
            lengths.add(len(loader))
            for epoch in (0, 1):
                loader.batch_sampler.set_epoch(epoch)
                ref.set_epoch(epoch)
                got = [[i for i, _ in b] for b in loader.batch_sampler]
                assert got == [[int(i) for i in b] for b in ref]
                assert all(len(b) == samples_per_gpu for b in got)
        assert len(lengths) == 1


@pytest.fixture(scope='module')
def multi_set(tmp_path_factory):
    """The 5-image test set's data config."""
    from test_torch_port_eval_slice import TEST_PIPELINE, data_cfg, make_set
    root = tmp_path_factory.mktemp('multi')
    return data_cfg(*make_set(root, num_imgs=5), TEST_PIPELINE)


@pytest.fixture(scope='module')
def multi_run(toy, multi_set, tmp_path_factory):
    """Two ranks of ``multi_device_test`` over a 5-image set (rank 0 also
    runs ``single_device_test``), JAX's over 2 devices, and the port's
    pasted probabilities (for the threshold band)."""
    from dynamask_tpu.apis.test import multi_device_test as jax_multi
    from dynamask_tpu.data import build_dataset as jax_build
    from dynamask_torch.apis import dataset_mask_canvas
    from dynamask_torch.data import build_dataset
    from dynamask_torch.ops.paste import paste_masks
    det, variables, port, cfgs = toy
    cfg = multi_set
    ranks = run_ranks(multi_test, 2, str(tmp_path_factory.mktemp('ranks')),
                      cfgs, numpy_state(port.eval()), cfg)
    ref = jax_multi(det, variables, jax_build(cfg, dict(test_mode=True)),
                    devices=jax.devices()[:2])
    pds = build_dataset(cfg, dict(test_mode=True))
    ch, cw = dataset_mask_canvas(pds)
    probs = {}
    for i in range(len(pds)):
        s = pds[i]
        b = {k: torch.from_numpy(s[k])[None]
             for k in ('image', 'img_shape', 'ori_shape', 'scale_factor')}
        with torch.no_grad():
            out = port.simple_test(b)
        oh, ow = s['ori_shape'].astype(int)
        probs[pds.sample_id(i)] = paste_masks(
            out['mask_probs'][0], out['dets'][0, :, :4], ch,
            cw)[:, :oh, :ow].numpy()
    return ranks, ref, probs


def test_multi_device_test_is_single_device_test(multi_run):
    """Both ranks return ``single_device_test``'s results, in its order
    (the landscape group, then the portrait one), each image once."""
    ranks = multi_run[0]
    single = ranks[0]['single']
    assert [r['img_id'] for r in single] == [1, 3, 5, 2, 4]
    for rank in ranks:
        got = rank['multi']
        assert [r['img_id'] for r in got] == [r['img_id'] for r in single]
        for a, b in zip(got, single):
            assert a.keys() == b.keys()
            for k in ('dets', 'labels', 'valid'):
                np.testing.assert_array_equal(a[k], b[k])
            assert len(a['masks']) == len(b['masks'])
            for m, n in zip(a['masks'], b['masks']):
                np.testing.assert_array_equal(m, n)


def test_multi_device_test_interleaves_samples_per_device(toy, multi_set,
                                                         multi_run,
                                                         tmp_path):
    """At two images a rank a batch, each global batch of 4 holds rank r's
    j-th image at r + 2 j (the sampler gives rank r ``chunk[r::2]``): the
    results are ``single_device_test``'s, in its order, each image once
    (the landscape group's batch wraps around to its first image, the
    portrait group's twice). A batch of two sums the CPU's convolutions
    and products in other orders than a batch of one, so the dets are held
    to the eval slice's 1e-4 and the masks outside the 1e-3 band around
    the threshold; validity and labels equal."""
    ranks, _, probs = multi_run
    single = ranks[0]['single']
    ranks = run_ranks(multi_test, 2, str(tmp_path), toy[3],
                      numpy_state(toy[2].eval()), multi_set, 2, False)
    for rank in ranks:
        got = rank['multi']
        assert [r['img_id'] for r in got] == [r['img_id'] for r in single]
        for a, b in zip(got, single):
            assert a.keys() == b.keys()
            for k in ('labels', 'valid'):
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a['dets'], b['dets'], rtol=1e-5,
                                       atol=1e-4)
            clear = np.abs(probs[a['img_id']] - 0.5) > 1e-3
            assert len(a['masks']) == len(b['masks'])
            for d, (m, n) in enumerate(zip(a['masks'], b['masks'])):
                np.testing.assert_array_equal(m[clear[d]], n[clear[d]])


def test_multi_device_test_against_jax(multi_run):
    """Rank 0's results against JAX's ``multi_device_test`` over 2
    devices, as ``test_torch_port_eval_slice`` holds the single-device
    loops: labels and validity equal, dets to 1e-4, masks equal outside
    the 1e-3 band around the threshold."""
    ranks, ref, probs = multi_run
    got = ranks[0]['multi']
    assert [r['img_id'] for r in ref] == [r['img_id'] for r in got]
    for g, r in zip(got, ref):
        valid = r['valid'].astype(bool)
        assert valid.sum() >= 4
        np.testing.assert_array_equal(g['valid'], r['valid'])
        np.testing.assert_array_equal(g['labels'], r['labels'])
        np.testing.assert_allclose(g['dets'], r['dets'], rtol=1e-5,
                                   atol=1e-4)
        clear = np.abs(probs[g['img_id']] - 0.5) > 1e-3
        for d in range(len(r['masks'])):
            assert g['masks'][d].shape == r['masks'][d].shape
            np.testing.assert_array_equal(g['masks'][d][clear[d]],
                                          r['masks'][d][clear[d]])


def test_launcher_env(monkeypatch):
    """``--launcher pytorch``'s group from torchrun's environment (a group
    of one on the CPU over gloo, ``env://`` on a free local port); a
    missing variable raises, naming it."""
    import socket
    import torch.distributed as dist
    from dynamask_torch.engine import (active_group, destroy_group,
                                       init_group_from_env)
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
               MASTER_ADDR='localhost', MASTER_PORT=str(port))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert init_group_from_env('cpu') == torch.device('cpu')
        assert dist.get_world_size() == 1 and dist.get_backend() == 'gloo'
        assert active_group() is dist.group.WORLD
    finally:
        destroy_group()
    assert active_group() is None
    monkeypatch.delenv('MASTER_PORT')
    with pytest.raises(RuntimeError, match='MASTER_PORT'):
        init_group_from_env('cpu')

"""The whole slice on the CPU: image -> boxes, labels and pasted masks, the
PyTorch port (``inference_detector``) against the JAX package
(``simple_test`` + ``_paste_epilogue``), slot for slot, at the toy DynaMask
config (ResNet-18, 32-channel FPN, 8 classes, 64x64) in both modes: the
faithful full cascade and the MSM-routed buckets at the flagship's shipped
capacities (1.0, 1.0, 0.01), for one image and for two.

Margins: the seeded weights and image give valid detections whose scores
are at least 1e-4 apart (checked below), so NMS order and the kept set are
not decided by fp32 rounding; mask pixels within 1e-3 of the 0.5 threshold
are excluded from the binary comparison and covered by the probability
comparison instead.
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

from test_torch_port_modules import toy_pair  # noqa: E402


# a two-image batch with a non-unit scale factor exercises the per-image
# RoI routing and the rescale of dets back to the input for the mask branch
@pytest.mark.parametrize('dynamic,b', [(False, 1), (True, 1), (True, 2)])
def test_simple_test_and_paste(dynamic, b):
    from test_models import demo_batch
    from dynamask_tpu.apis.test import _paste_epilogue
    from dynamask_tpu.ops.paste import paste_masks as jpaste
    from dynamask_torch.apis import inference_detector
    from dynamask_torch.ops.paste import paste_masks

    det, variables, port, _ = toy_pair(dynamic=dynamic,
                                       capacity=(1.0, 1.0, 0.01))
    demo = demo_batch(0, b=b, h=64, w=64, g=3, s=16)
    keys = ('image', 'img_shape', 'ori_shape', 'scale_factor')
    batch_np = {k: np.array(demo[k]) for k in keys}
    batch_np['scale_factor'][1:] = 0.8

    def flat(out):
        return (out['mask_probs'].reshape(-1, 112, 112),
                out['dets'][..., :4].reshape(-1, 4))

    @jax.jit
    def jax_fn(v, batch):
        out = det.apply(v, batch, method='simple_test')
        return out, jpaste(*flat(out), 64, 64), _paste_epilogue(out, 64, 64,
                                                                 0.5)

    ref, ref_pasted, ref_epi = jax.tree_util.tree_map(
        np.asarray, jax_fn(variables,
                           {k: jnp.asarray(v) for k, v in batch_np.items()}))

    batch_t = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    got = inference_detector(port, batch_t)
    with torch.no_grad():
        out = port.simple_test(batch_t)
        pasted = paste_masks(*flat(out), 64, 64).numpy()

    for i in range(b):
        valid = ref['det_valid'][i].astype(bool)
        assert valid.sum() >= 4
        scores = np.sort(ref['dets'][i, valid, 4])
        assert np.min(np.diff(scores)) > 1e-4, 'score margins too small'

    np.testing.assert_array_equal(got['valid'].numpy(), ref['det_valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    # box coordinates up to 64 px from fp32 decode on both sides
    np.testing.assert_allclose(got['dets'].numpy(), ref['dets'], rtol=1e-5,
                               atol=1e-4)
    # mask probabilities after the cascade and boundary fusion (fp32)
    np.testing.assert_allclose(out['mask_probs'].numpy(), ref['mask_probs'],
                               atol=2e-4)
    np.testing.assert_allclose(pasted, ref_pasted, atol=2e-4)
    clear = np.abs(ref_pasted - 0.5) > 1e-3
    masks = got['masks'].numpy()
    assert masks.shape == (b, valid.size, 64, 64)
    np.testing.assert_array_equal(masks.reshape(pasted.shape)[clear],
                                  ref_epi['masks'].reshape(pasted.shape)[clear])
    assert ('msm_routing' in got) == dynamic

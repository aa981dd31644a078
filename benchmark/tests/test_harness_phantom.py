"""The benchmark's frozen phantom equals the program's generator bit for bit."""

import numpy as np
import pytest

from benchmark import phantom
from runet_tpu_torch.data.phantom import make_phantom


@pytest.mark.parametrize("kw", [
    dict(shape=(40, 36, 24), spacing=(0.78125, 0.78125, 3.0), num_classes=3, seed=7),
    dict(shape=(40, 40, 20), spacing=(0.78125, 0.78125, 3.0), num_classes=5, seed=2**31 - 5),
    dict(shape=(32, 32, 16), num_classes=5, seed=3, tumor_lobes=3, tumor_hu=42.0,
         vessel_radius=1.5, kidney_scale=0.8),
])
def test_frozen_copy_is_the_programs_generator(kw):
    img, lab = phantom.make_phantom(**kw)
    want_img, want_lab = make_phantom(**kw)
    assert img.dtype == want_img.dtype and lab.dtype == want_lab.dtype
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_array_equal(lab, want_lab)


def test_pool_in_threads_equals_one_thread():
    kws = [dict(shape=(24, 24, 16), num_classes=5, seed=s) for s in (1, 2, 3)]
    pooled = phantom.make_pool(kws, labels=True, threads=2)
    for kw, (img, lab) in zip(kws, pooled):
        want_img, want_lab = phantom.make_phantom(**kw)
        np.testing.assert_array_equal(img, want_img)
        np.testing.assert_array_equal(lab, want_lab)
    images = phantom.make_pool(kws[:2], threads=1)
    np.testing.assert_array_equal(images[1], phantom.make_phantom(**kws[1])[0])

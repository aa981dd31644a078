"""The port's native host tier (``runet_tpu_torch/utils/native.py`` over its
own copy of ``cc3d.cpp``) against the JAX package's on the same seeded
numpy inputs: labels, sizes, boxes, kept voxels and pasted canvases equal
exactly. Then the port's postprocess chain with the tier against the same
chain with the loader patched to ``None`` (scipy/numpy), on data where no
two components have the same size, so that no ranking tie can split them;
and the call counters and ``available()``."""

import threading

import numpy as np
import pytest
import torch
from scipy import ndimage

from runet_tpu.infer import postprocess as jpost
from runet_tpu.utils import native as jn
from runet_tpu_torch.infer import postprocess as tpost
from runet_tpu_torch.infer.packing import pack_crumbs, pack_nibbles
from runet_tpu_torch.utils import native as tn

SEEDS = (0, 1, 2)


@pytest.fixture(autouse=True, scope="module")
def _both_tiers_built():
    if not tn.available():
        pytest.fail(f"the port's native tier did not build: {tn.build_error()}")
    assert jn._load() is not None, "the JAX package's native tier did not build"


def _speckle(seed, shape=(23, 19, 17), density=0.35, classes=3):
    rng = np.random.default_rng(seed)
    fg = rng.random(shape) < density
    return (fg * rng.integers(1, classes, shape)).astype(np.uint8)


def _tie_free(seed, shape=(26, 22, 20)):
    """A uint8 canvas of classes 1-2 whose 6-connected components all have
    distinct sizes: blobs from smoothed noise, then every component whose
    size an earlier one already has is removed."""
    rng = np.random.default_rng(seed)
    field = ndimage.uniform_filter(rng.random(shape), size=3)
    seg = (field > np.quantile(field, 0.72)).astype(np.uint8)
    seg *= rng.integers(1, 3, shape).astype(np.uint8)
    lab, n = ndimage.label(seg > 0)
    sizes = np.bincount(lab.ravel(), minlength=n + 1)
    seen, drop = set(), np.zeros(n + 1, bool)
    for c in range(1, n + 1):
        drop[c] = sizes[c] in seen
        seen.add(int(sizes[c]))
    seg[drop[lab]] = 0
    lab, n = ndimage.label(seg > 0)
    sizes = np.bincount(lab.ravel())[1:]
    assert n >= 6 and len(set(sizes.tolist())) == n
    return seg


# ------------------------------------------------- each entry point vs JAX


@pytest.mark.parametrize("seed", SEEDS)
def test_label_components_3d_equals_jax(seed):
    mask = np.ascontiguousarray(_speckle(seed) > 0, np.uint8)
    got, gn = tn.native_label_components(mask)
    want, wn = jn.native_label_components(mask)
    assert gn == wn > 10
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_component_stats_3d_equals_jax(seed):
    labels, n = jn.native_label_components(np.ascontiguousarray(_speckle(seed) > 0, np.uint8))
    gs, gb = tn.native_component_stats(labels, n)
    ws, wb = jn.native_component_stats(labels, n)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gb, wb)
    assert tn.native_component_stats(labels, 0) is None


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("keep_k,min_voxels", [(2, 0), (5, 3)])
def test_keep_largest_components_3d_equals_jax(seed, keep_k, min_voxels):
    seg = _speckle(seed)
    labels, n = jn.native_label_components(np.ascontiguousarray(seg > 0, np.uint8))
    got, want = seg.copy(), seg.copy()
    assert tn.native_keep_largest(got, labels, n, keep_k, min_voxels)
    assert jn.native_keep_largest(want, labels, n, keep_k, min_voxels)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_zero_nonkept_3d_equals_jax(seed):
    seg = _speckle(seed)
    labels, n = jn.native_label_components(np.ascontiguousarray(seg > 0, np.uint8))
    lut = (np.random.default_rng(seed).random(n + 1) < 0.5).astype(np.uint8)
    got, want = seg.copy(), seg.copy()
    assert tn.native_zero_nonkept(got, labels, lut)
    assert jn.native_zero_nonkept(want, labels, lut)
    np.testing.assert_array_equal(got, want)
    assert (got != seg).any() and (got > 0).any()


BOXES = [
    [[0, 0, 0, 23, 19, 17]],                                  # the whole canvas
    [[1, 2, 0, 10, 19, 9], [12, 0, 5, 23, 11, 17]],            # disjoint
    [[0, 0, 0, 8, 8, 8], [8, 0, 0, 16, 8, 8], [3, 10, 2, 20, 18, 16]],  # face-adjacent
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("boxes", BOXES, ids=["whole", "disjoint", "face-adjacent"])
def test_keep_largest_in_boxes_3d_equals_jax(seed, boxes):
    seg = _speckle(seed)
    arr = np.asarray(boxes, np.int64)
    got, want = seg.copy(), seg.copy()
    assert tn.native_keep_largest_in_boxes(got, arr, 2, 1)
    assert jn.native_keep_largest_in_boxes(want, arr, 2, 1)
    np.testing.assert_array_equal(got, want)


def _pastes(seed, classes, pack):
    """Two overlapping crops of labels < ``classes``, packed along z as the
    cascade fetches them (a bucket-padded buffer, an odd pasted extent), and
    the canvas they land on, already holding labels."""
    rng = np.random.default_rng(seed)
    canvas = _speckle(seed + 10, (30, 26, 35), 0.2, classes)
    crops = []
    for lo, ext, buf in [((2, 3, 1), (17, 11, 29), (20, 16, 32)),
                         ((9, 8, 6), (19, 17, 23), (19, 18, 28))]:
        lab = (rng.random(buf) < 0.6) * rng.integers(1, classes, buf)
        packed = pack(torch.from_numpy(lab.astype(np.uint8))).numpy()
        crops.append((np.asarray(lo), np.asarray(ext), packed))
    return canvas, crops


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["crumbs", "nibbles"])
def test_paste_3d_equals_jax(seed, which):
    classes, pack = (4, pack_crumbs) if which == "crumbs" else (16, pack_nibbles)
    canvas, crops = _pastes(seed, classes, pack)
    got, want = canvas.copy(), canvas.copy()
    for lo, ext, packed in crops:
        assert getattr(tn, f"native_paste_{which}")(got, packed, lo, ext)
        assert getattr(jn, f"native_paste_{which}")(want, packed, lo, ext)
    np.testing.assert_array_equal(got, want)
    assert (got != canvas).any()


def test_paste_takes_a_strided_batch_sample():
    """A batched group's sample ``host[bidx]`` pastes as its contiguous copy."""
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 3, (2, 12, 10, 15)).astype(np.uint8)
    host = pack_crumbs(torch.from_numpy(lab)).numpy()
    sample = np.asfortranarray(host)[1]
    assert not sample.flags.c_contiguous
    a, b = np.zeros((20, 20, 20), np.uint8), np.zeros((20, 20, 20), np.uint8)
    assert tn.native_paste_crumbs(a, sample, (1, 2, 3), (12, 10, 15))
    assert tn.native_paste_crumbs(b, np.ascontiguousarray(host[1]), (1, 2, 3), (12, 10, 15))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[1:13, 2:12, 3:18], lab[1])


# ------------------------------------------- the postprocess chain vs JAX


@pytest.mark.parametrize("seed", SEEDS)
def test_keep_largest_components_in_boxes_overlapping_equals_jax(seed):
    """Overlapping and face-adjacent boxes: both packages merge them first and
    rank across the merged boxes."""
    seg = _speckle(seed, (30, 28, 26), 0.3)
    seg[3:12, 3:12, 3:12] = 1
    seg[12:20, 5:13, 4:10] = 2  # face-adjacent to the first block
    boxes = [(np.array([2, 2, 2]), np.array([12, 13, 13])),
             (np.array([12, 4, 3]), np.array([21, 14, 11])),   # shares a face
             (np.array([8, 10, 8]), np.array([25, 27, 24])),   # overlaps both
             (np.array([26, 0, 20]), np.array([30, 4, 26]))]   # apart
    for mv in (0, 5):
        np.testing.assert_array_equal(
            tpost.keep_largest_components_in_boxes(seg, boxes, 2, mv),
            jpost.keep_largest_components_in_boxes(seg, boxes, 2, mv))


@pytest.mark.parametrize("seed", SEEDS)
def test_postprocess_functions_equal_jax(seed):
    seg = _speckle(seed, (28, 24, 22), 0.3)
    seg[4:14, 4:12, 3:15] = 1
    seg[16:26, 14:22, 6:18] = 2
    for fg in (None, (1,), (1, 2)):
        np.testing.assert_array_equal(tpost.keep_largest_components(seg, fg, 2, 2),
                                      jpost.keep_largest_components(seg, fg, 2, 2))
    got, want = tpost.label_components(seg > 0), jpost.label_components(seg > 0)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    for (a, b), (c, d) in zip(tpost.component_bounding_boxes(seg > 0, 3, 8),
                              jpost.component_bounding_boxes(seg > 0, 3, 8), strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# ------------------------------- native chain vs scipy chain, tie-free data


def _without_native(monkeypatch, fn, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(tn, "_load", lambda: None)
        before = tn.call_counts()
        out = fn(*args, **kw)
        assert tn.call_counts() == before, "a native entry point ran with the loader at None"
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_native_chain_equals_scipy_chain_on_tie_free_data(seed, monkeypatch):
    seg = _tie_free(seed)
    mask = seg > 0
    nat = tpost.label_components(mask)
    sci = _without_native(monkeypatch, tpost.label_components, mask)
    assert nat[1] == sci[1]
    np.testing.assert_array_equal(nat[0], sci[0])
    for k, mv in ((1, 0), (2, 3), (4, 0)):
        for fg in (None, (1, 2)):
            np.testing.assert_array_equal(
                tpost.keep_largest_components(seg, fg, k, mv),
                _without_native(monkeypatch, tpost.keep_largest_components, seg, fg, k, mv))
        nb = tpost.component_bounding_boxes(mask, k, 2)
        sb = _without_native(monkeypatch, tpost.component_bounding_boxes, mask, k, 2)
        assert len(nb) == len(sb) == k
        for (a, b), (c, d) in zip(nb, sb):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    boxes = [(np.array([0, 0, 0]), np.array([12, 22, 20])),
             (np.array([12, 0, 0]), np.array([20, 10, 20])),
             (np.array([15, 5, 4]), np.array([26, 22, 17]))]
    for k in (1, 2, 3):
        np.testing.assert_array_equal(
            tpost.keep_largest_components_in_boxes(seg, boxes, k),
            _without_native(monkeypatch, tpost.keep_largest_components_in_boxes, seg, boxes, k))


def test_fallback_chain_equals_jax_fallback_chain(monkeypatch):
    """With both loaders at None the two packages' scipy chains agree."""
    seg = _tie_free(4)
    boxes = [(np.array([1, 1, 1]), np.array([14, 20, 18])),
             (np.array([13, 3, 2]), np.array([26, 22, 19]))]
    monkeypatch.setattr(tn, "_load", lambda: None)
    monkeypatch.setattr(jn, "_load", lambda: None)
    np.testing.assert_array_equal(tpost.keep_largest_components_in_boxes(seg, boxes, 2),
                                  jpost.keep_largest_components_in_boxes(seg, boxes, 2))
    np.testing.assert_array_equal(tpost.keep_largest_components(seg, None, 2),
                                  jpost.keep_largest_components(seg, None, 2))
    for (a, b), (c, d) in zip(tpost.component_bounding_boxes(seg > 0, 3, 4),
                              jpost.component_bounding_boxes(seg > 0, 3, 4), strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# ------------------------------------------- the loader and its counters


def test_available_and_library_path():
    assert tn.available() and tn.build_error() is None
    path = tn.library_path()
    assert path.parent == tn.BUILD_DIR and path.name.startswith("libcc3d-") and path.exists()
    assert set(tn.call_counts()) == set(tn.SYMBOLS) and len(tn.SYMBOLS) == 7


def test_a_failed_build_reports_its_error(monkeypatch):
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_build_error", None)
    monkeypatch.setattr(tn, "library_path", lambda: tn.BUILD_DIR / "libcc3d-does-not-exist.so")

    def fail(out):
        raise RuntimeError("g++ failed (rc 1):\nsome compiler error")

    monkeypatch.setattr(tn, "_build", fail)
    assert not tn.available()
    assert "some compiler error" in tn.build_error()
    assert tn.native_label_components(np.ones((2, 2, 2), np.uint8)) is None
    assert not tn.native_paste_crumbs(np.zeros((2, 2, 2), np.uint8),
                                      np.zeros((2, 2, 1), np.uint8), (0, 0, 0), (2, 2, 2))


def test_call_counters_count_each_entry_point_and_reset():
    seg = _speckle(0)
    tn.reset_call_counts()
    assert set(tn.call_counts().values()) == {0}
    tpost.component_bounding_boxes(seg > 0, 2, 1)
    tpost.keep_largest_components(seg, (1,), 2)
    tpost.keep_largest_components_in_boxes(seg, [(np.zeros(3, int), np.asarray(seg.shape))], 2)
    counts = tn.call_counts()
    assert counts["label_components_3d"] == 2
    assert counts["component_stats_3d"] == 1
    assert counts["keep_largest_components_3d"] == 1
    assert counts["keep_largest_in_boxes_3d"] == 1
    tn.reset_call_counts()
    assert set(tn.call_counts().values()) == {0}


def test_call_counters_are_thread_safe():
    mask = np.ascontiguousarray(_speckle(1, (8, 8, 8)) > 0, np.uint8)
    tn.reset_call_counts()

    def work():
        for _ in range(200):
            tn.native_label_components(mask)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tn.call_counts()["label_components_3d"] == 800
    tn.reset_call_counts()


def test_tie_breaking_follows_the_jax_package_in_each_chain(monkeypatch):
    """On speckle with equal-sized components the native chain (C++
    ``partial_sort``) and the scipy chain (``argsort`` / ``argpartition``)
    may keep different components of a tied size: observed, not a fault,
    as in the JAX package. Each chain equals the JAX package's same chain."""
    box = [(np.zeros(3, int), np.array([8, 14, 12])), (np.array([8, 0, 0]), np.array([16, 14, 12]))]
    split = 0
    for seed in range(12):
        rng = np.random.default_rng(seed)
        seg = ((rng.random((16, 14, 12)) < 0.12) * rng.integers(1, 3, (16, 14, 12))).astype(np.uint8)
        outs = {}
        for chain in ("native", "scipy"):
            with monkeypatch.context() as m:
                if chain == "scipy":
                    m.setattr(tn, "_load", lambda: None)
                    m.setattr(jn, "_load", lambda: None)
                for pkg, mod in (("port", tpost), ("jax", jpost)):
                    outs[chain, pkg] = (mod.keep_largest_components(seg, None, 2),
                                        mod.keep_largest_components_in_boxes(seg, box, 2))
        for chain in ("native", "scipy"):
            for a, b in zip(outs[chain, "port"], outs[chain, "jax"]):
                np.testing.assert_array_equal(a, b)
        split += not np.array_equal(outs["native", "port"][0], outs["scipy", "port"][0])
    assert split > 0, "no tie split the chains on this data; the test no longer shows it"


@pytest.mark.parametrize("call", ["label-dtype", "paste-outside", "box-outside", "lut-short"])
def test_a_wrong_layout_raises_before_the_call(call):
    """Layouts the C code would index out of bounds are refused with a
    ValueError (not an assert, which ``python -O`` removes), and no call is
    counted."""
    seg = _speckle(0)
    labels, n = tn.native_label_components(np.ascontiguousarray(seg > 0, np.uint8))
    tn.reset_call_counts()
    with pytest.raises(ValueError, match="native host tier"):
        if call == "label-dtype":
            tn.native_label_components(seg.astype(np.int16))
        elif call == "paste-outside":
            packed = pack_crumbs(torch.ones((4, 4, 8), dtype=torch.uint8)).numpy()
            tn.native_paste_crumbs(np.zeros((6, 6, 6), np.uint8), packed, (3, 0, 0), (4, 4, 6))
        elif call == "box-outside":
            tn.native_keep_largest_in_boxes(seg.copy(), np.asarray([[0, 0, 0, 24, 19, 17]]), 2)
        else:
            tn.native_zero_nonkept(seg.copy(), labels, np.ones(n, np.uint8))
    assert set(tn.call_counts().values()) == {0}

"""The video datasets, ``flow_util`` and ``augment``'s flows: the port vs
bem_tpu on seeded PNG clips.

- ``flow_util``: ``quantize`` / ``dequantize`` / ``quantize_flow`` /
  ``dequantize_flow`` equal bem_tpu's; a ``.flo`` file and a quantized
  flow PNG written by either side read back equal by both.
- ``augment`` with ``flows`` and ``return_status`` equals bem_tpu's under
  the same draws, every flip combination.
- ``generate_frame_indices`` (every padding) and ``duf_downsample`` equal
  bem_tpu's.
- The eight datasets, built by ``build_dataset``: each item equals
  bem_tpu's under the same draws. bem_tpu draws from its module-level
  ``random`` and from fresh generators in ``paired_random_crop`` /
  ``augment``; one ``_Draws`` stub serves them all (tests/
  test_torch_datasets_more.py's), and a copy of it is the port's
  ``rng``. Clips: 10 frames of GT 32x32 / LQ 8x8 (REDS, scale 4; two train
  clips and the REDS4 clip 000), Vimeo90K septuplets, quantized flows
  written by the port's ``flowwrite``.
"""

import functools
import os

import numpy as np
import pytest

import bem_tpu.data.video_datasets as bem_vd
from bem_tpu.data.transforms import augment as bem_augment
from bem_tpu.utils import flow_util as bem_flow
from bem_tpu_torch.data import build_dataset
from bem_tpu_torch.data import video_datasets as vd
from bem_tpu_torch.data.transforms import augment
from bem_tpu_torch.utils import flow_util
from bem_tpu_torch.utils.img_util import imwrite

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

NF, GT, LQ = 10, 32, 8


class _Draws:
    """Uniform draws in [0, 1) served to ``random``'s and a numpy
    generator's methods alike, in call order."""

    def __init__(self, values):
        self.values = list(values)

    def random(self):
        return self.values.pop(0)

    def integers(self, lo, hi=None):
        lo, hi = (0, lo) if hi is None else (lo, hi)
        return lo + int(self.random() * (hi - lo))

    def randint(self, a, b):
        return self.integers(a, b + 1)

    def choice(self, seq):
        return seq[self.integers(len(seq))]


def _png(path, rng, size):
    imwrite(rng.integers(0, 256, (size, size, 3)).astype(np.uint8), path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("video"))
    rng = np.random.default_rng(0)
    for clip in ("000", "001", "002"):  # REDS: 000 is in REDS4
        for n in range(NF):
            _png(f"{root}/reds_gt/{clip}/{n:08d}.png", rng, GT)
            _png(f"{root}/reds_lq/{clip}/{n:08d}.png", rng, LQ)
            for tag in ("p", "n"):
                for i in (1, 2):
                    flow = rng.uniform(-30, 30, (LQ, LQ, 2)).astype(np.float32)
                    flow_util.flowwrite(flow, f"{root}/reds_flow/{clip}/{n:08d}_{tag}{i}.png",
                                        quantize=True, max_val=20, norm=False)
    with open(f"{root}/reds_meta.txt", "w") as f:
        f.writelines(f"{c} {NF} ({GT},{GT},3)\n" for c in ("000", "001", "002"))
    seqs = ("00001/0001", "00001/0002", "00002/0001")
    for seq in seqs:
        for n in range(1, 8):
            _png(f"{root}/vimeo_gt/{seq}/im{n}.png", rng, GT)
            _png(f"{root}/vimeo_lq/{seq}/im{n}.png", rng, LQ)
    with open(f"{root}/vimeo_meta.txt", "w") as f:
        f.writelines(f"{s} 7 ({GT},{GT},3)\n" for s in seqs)
    for clip, n in (("a", 6), ("b", 5)):  # test clips: GT at the LQ's size x4
        for i in range(n):
            _png(f"{root}/test_gt/{clip}/{i:03d}.png", rng, GT)
            _png(f"{root}/test_lq/{clip}/{i:03d}.png", rng, LQ)
    return root


def _same_items(port, bem, indices, monkeypatch, seed):
    draws = np.random.default_rng(seed).random(64 * len(indices)).tolist()
    stub = _Draws(draws)
    monkeypatch.setattr(bem_vd, "random", stub)
    monkeypatch.setattr(bem_vd, "paired_random_crop",
                        functools.partial(bem_vd.paired_random_crop, rng=stub))
    monkeypatch.setattr(bem_vd, "augment", functools.partial(bem_vd.augment, rng=stub))
    port.rng = _Draws(draws)
    assert len(port) == len(bem)
    for i in indices:
        a, b = port[i], bem[i]
        assert set(a) == set(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert port.rng.values == stub.values  # the same number of draws


def _reds(root, **kw):
    return dict(dict(type="REDSDataset", phase="train", dataroot_gt=f"{root}/reds_gt",
                     dataroot_lq=f"{root}/reds_lq", meta_info_file=f"{root}/reds_meta.txt",
                     io_backend={"type": "disk"}, num_frame=5, gt_size=16, scale=4,
                     interval_list=[1, 2], random_reverse=True, frames_per_clip=NF), **kw)


@pytest.mark.parametrize("flows", [False, True])
def test_reds(root, monkeypatch, flows):
    opt = _reds(root, dataroot_flow=f"{root}/reds_flow" if flows else None)
    port, bem = build_dataset(opt), bem_vd.REDSDataset(dict(opt))
    assert len(port) == 2 * NF
    _same_items(port, bem, [0, 3, 7, 9, 15, 3], monkeypatch, 1)
    item = port[5]
    assert item["lq"].shape == (5, 4, 4, 3) and item["gt"].shape == (16, 16, 3)
    if flows:
        assert item["flow"].shape == (5, 4, 4, 2) and not item["flow"][2].any()


def test_reds_val_partition(root, monkeypatch):
    opt = _reds(root, phase="val", interval_list=[1])
    port, bem = build_dataset(opt), bem_vd.REDSDataset(dict(opt))
    assert {k.split("/")[0] for k in port.keys} == {"000"}
    _same_items(port, bem, [0, 4], monkeypatch, 2)


@pytest.mark.parametrize("test_mode", [False, True])
def test_reds_recurrent(root, monkeypatch, test_mode):
    opt = _reds(root, type="REDSRecurrentDataset", num_frame=3, test_mode=test_mode)
    port, bem = build_dataset(opt), bem_vd.REDSRecurrentDataset(dict(opt))
    _same_items(port, bem, [0, 5, 7, 2], monkeypatch, 3)
    with pytest.raises(ValueError, match="Wrong validation partition"):
        build_dataset(dict(opt, val_partition="x"))


def _vimeo(root, **kw):
    return dict(dict(type="Vimeo90KDataset", phase="train", dataroot_gt=f"{root}/vimeo_gt",
                     dataroot_lq=f"{root}/vimeo_lq", meta_info_file=f"{root}/vimeo_meta.txt",
                     io_backend={"type": "disk"}, num_frame=7, gt_size=16, scale=4,
                     random_reverse=True), **kw)


@pytest.mark.parametrize("num_frame", [7, 3])
def test_vimeo90k(root, monkeypatch, num_frame):
    opt = _vimeo(root, num_frame=num_frame)
    port, bem = build_dataset(opt), bem_vd.Vimeo90KDataset(dict(opt))
    _same_items(port, bem, [0, 1, 2, 1], monkeypatch, 4)
    assert port[0]["lq"].shape == (num_frame, 4, 4, 3)


@pytest.mark.parametrize("flip_sequence", [False, True])
def test_vimeo90k_recurrent(root, monkeypatch, flip_sequence):
    opt = _vimeo(root, type="Vimeo90KRecurrentDataset", flip_sequence=flip_sequence)
    port, bem = build_dataset(opt), bem_vd.Vimeo90KRecurrentDataset(dict(opt))
    _same_items(port, bem, [0, 1, 2, 0, 1], monkeypatch, 5)


def _test_opt(root, kind, **kw):
    return dict(dict(type=kind, phase="test", dataroot_gt=f"{root}/test_gt",
                     dataroot_lq=f"{root}/test_lq", io_backend={"type": "disk"}, num_frame=3,
                     scale=4), **kw)


@pytest.mark.parametrize("kind,extra", [
    ("VideoTestDataset", {}), ("VideoTestDataset", {"padding": "circle", "num_frame": 5}),
    ("VideoTestDUFDataset", {}), ("VideoTestDUFDataset", {"use_duf_downsampling": True}),
    ("VideoRecurrentTestDataset", {})])
def test_video_test_sets(root, monkeypatch, kind, extra):
    opt = _test_opt(root, kind, **extra)
    port, bem = build_dataset(opt), getattr(bem_vd, kind)(dict(opt))
    _same_items(port, bem, list(range(len(port))), monkeypatch, 6)


def test_vimeo90k_test_set(root, monkeypatch):
    opt = dict(_vimeo(root, type="VideoTestVimeo90KDataset", phase="test"), num_frame=5)
    port, bem = build_dataset(opt), bem_vd.VideoTestVimeo90KDataset(dict(opt))
    _same_items(port, bem, [0, 1, 2], monkeypatch, 7)
    with pytest.raises(NotImplementedError, match="cache_data"):
        build_dataset(dict(opt, cache_data=True))


@pytest.mark.parametrize("padding", ["replicate", "reflection", "reflection_circle", "circle"])
def test_generate_frame_indices(padding):
    for n in (5, 7):
        for crt in range(9):
            assert (vd.generate_frame_indices(crt, 9, n, padding)
                    == bem_vd.generate_frame_indices(crt, 9, n, padding))


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_duf_downsample(scale):
    x = np.random.default_rng(scale).random((2, 36, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(vd.duf_downsample(x, scale=scale),
                                  bem_vd.duf_downsample(x, scale=scale))
    np.testing.assert_array_equal(vd.generate_gaussian_kernel(13, 1.2),
                                  bem_vd.generate_gaussian_kernel(13, 1.2))


def test_quantize_functions():
    rng = np.random.default_rng(0)
    flow = rng.uniform(-3, 3, (9, 7, 2))
    for fn in ("quantize", "dequantize"):
        a = rng.uniform(-2, 2, (5, 6))
        np.testing.assert_array_equal(getattr(flow_util, fn)(a, -1, 1, 7),
                                      getattr(bem_flow, fn)(a, -1, 1, 7))
        with pytest.raises(ValueError, match="levels"):
            getattr(flow_util, fn)(a, -1, 1, 1)
        with pytest.raises(ValueError, match="min_val"):
            getattr(flow_util, fn)(a, 1, 1, 7)
    for norm in (True, False):
        q, qb = flow_util.quantize_flow(flow, 0.5, norm), bem_flow.quantize_flow(flow, 0.5, norm)
        for a, b in zip(q, qb):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(flow_util.dequantize_flow(*q, 0.5, norm),
                                      bem_flow.dequantize_flow(*q, 0.5, norm))


@pytest.mark.parametrize("axis", [0, 1])
def test_flow_files_round_trip(tmp_path, axis):
    flow = np.random.default_rng(axis).uniform(-5, 5, (6, 10, 2)).astype(np.float32)
    flo = str(tmp_path / "a.flo")
    flow_util.flowwrite(flow, flo)
    np.testing.assert_array_equal(bem_flow.flowread(flo), flow)
    bem_flow.flowwrite(flow, str(tmp_path / "b.flo"))
    np.testing.assert_array_equal(flow_util.flowread(str(tmp_path / "b.flo")), flow)
    with open(flo, "rb") as f:
        assert f.read() == open(str(tmp_path / "b.flo"), "rb").read()
    for write, name in ((flow_util.flowwrite, "q_port.png"), (bem_flow.flowwrite, "q_bem.png")):
        path = str(tmp_path / "q" / name)
        write(flow, path, quantize=True, concat_axis=axis, max_val=1.0)
        got = flow_util.flowread(path, quantize=True, concat_axis=axis, max_val=1.0)
        want = bem_flow.flowread(path, quantize=True, concat_axis=axis, max_val=1.0)
        assert got.dtype == np.float32 and got.shape == flow.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IOError, match="Invalid flow file"):
        flow_util.flowread(str(tmp_path / "q" / "q_port.png"))
    assert os.path.getsize(flo) == 12 + flow.nbytes


def test_augment_flows_and_status():
    rng = np.random.default_rng(0)
    imgs = [rng.random((6, 8, 3)).astype(np.float32) for _ in range(2)]
    flows = [rng.random((6, 8, 2)).astype(np.float32) for _ in range(2)]
    for bits in range(8):
        draws = [0.25 if bits >> i & 1 else 0.75 for i in range(3)]
        got = augment(imgs, True, True, flows, rng=_Draws(draws))
        want = bem_augment(imgs, True, True, flows, rng=_Draws(draws))
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(a, b)
        got_i, status = augment(imgs[0], True, True, return_status=True, rng=_Draws(draws))
        want_i, want_status = bem_augment(imgs[0], True, True, return_status=True,
                                          rng=_Draws(draws))
        assert status == want_status
        np.testing.assert_array_equal(got_i, want_i)
        one, f1 = augment(imgs[0], True, True, flows[0], rng=_Draws(draws))
        np.testing.assert_array_equal(f1, want[1][0])

"""The UIQM + UCIQE selection of the eval CLI and the two folder CLIs,
the port vs bem_tpu.

- ``--no_ref uiqm_uciqe`` at ``--uiqm_weight`` 1.0 and 0.5: bem_tpu's
  ``main`` and the port's on K distinct candidates, each sample's weight
  noise injected into both (test_torch_eval_select.py's machinery, whose
  checks these are: each side writes its best image, then its candidates
  by descending score; every candidate of bem_tpu's is one of the port's
  within 1 LSB, scored alike; bem_tpu's pick is the port's). The scores
  of the two sides differ where a candidate's rounding to uint8 does (1
  LSB at a few pixels); the scorer itself is held on the port's own
  candidates: bem_tpu's ``getUIQM`` (on Pillow's resize) and ``getUCIQE``
  give the port's values within 1e-5 relative and 1e-8. result.txt's
  ``Best_UIQM`` / ``Best_UCIQE`` lines (and the PSNR / SSIM of the pick
  against the targets) agree to their 4 decimals.
- ``eval_uciqe_uiqm`` and ``cal_metrics_with_imgs`` (plain, ``--GT_mean``,
  ``--lpips`` on seeded AlexNet-shaped weights) against bem_tpu's on
  folders of PNG and JPEG files, to the 4 decimals they print; unequal
  folders raise.
"""

import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import bem_tpu.enhancement.eval as jax_eval
import bem_tpu.utils.img_util as jax_img_util
import bem_tpu_torch.enhancement.eval as port_eval
from bem_tpu.enhancement import cal_metrics_with_imgs as jax_cal
from bem_tpu.enhancement import eval_uciqe_uiqm as jax_folder
from bem_tpu.enhancement.eval import main as jax_main
from bem_tpu.metrics import uciqe_uiqm as jm
from bem_tpu_torch.enhancement import cal_metrics_with_imgs as port_cal
from bem_tpu_torch.enhancement import eval_uciqe_uiqm as port_folder

from test_torch_eval_cli import _result_lines, env, one_torch_thread  # noqa: F401  (fixtures)
from test_torch_eval_select import K, NIMG, _args, _inject, _per_image, _record, mid  # noqa: F401
from test_torch_cpu_setup import quick_compile  # noqa: F401  (module fixtures)
from test_torch_eval_metrics import _ALEX
from test_torch_jpeg import scene

# how far a score (the ratio to the K candidates' best) may move when a
# candidate's uint8 rounding moves by 1 LSB at a few pixels
SCORE_TOL = 2e-3


@pytest.mark.parametrize("weight", ["1.0", "0.5"])
def test_uiqm_uciqe_selection(mid, monkeypatch, weight):  # noqa: F811
    _inject(monkeypatch)
    extra = ["--no_ref", "uiqm_uciqe", "--uiqm_weight", weight]
    tag = f"uiqm_{weight}"
    jw = _record(monkeypatch, jax_img_util, "imwrite", bgr=True)
    jax_main(_args(mid, f"{tag}_jax", "input", extra))
    seen = []
    real = port_eval.uiqm_uciqe_batch

    def scorer(cands):
        out = real(cands)
        seen.append((cands.numpy().copy(), out))
        return out

    monkeypatch.setattr(port_eval, "uiqm_uciqe_batch", scorer)
    pw = _record(monkeypatch, port_eval, "imwrite", bgr=False)
    got = port_eval.main(_args(mid, f"{tag}_port", "input", extra + ["--device", "cpu"]))

    assert len(seen) == NIMG
    for cands, (uiqms, uciqes) in seen:
        u8 = (cands * 255).round().astype(np.uint8)
        h, w = u8.shape[1:3]
        small = [np.array(Image.fromarray(c).resize((256, int(256 / w * h)))) for c in u8]
        np.testing.assert_allclose(uiqms, [jm.getUIQM(s) for s in small], rtol=1e-5)
        np.testing.assert_allclose(uciqes, [jm.getUCIQE(c) for c in u8], rtol=0, atol=1e-8)

    jimgs, pimgs = _per_image(jw), _per_image(pw)
    assert len(jimgs) == len(pimgs) == NIMG
    for i, ((jbest, jc), (pbest, pc)) in enumerate(zip(jimgs, pimgs)):
        scores = np.array(got["scores"][i])
        order = np.argsort(scores)[::-1]
        assert len(jc) == len(pc) == K
        assert got["selected"][i] == order[0]
        assert [s for s, _ in pc] == [float(f"{v:.2f}") for v in scores[order]]
        np.testing.assert_array_equal(pbest, pc[0][1])
        np.testing.assert_array_equal(jbest, jc[0][1])
        cand = [c.astype(int) for _, c in pc]
        assert min(np.abs(a - b).max() for j, a in enumerate(cand) for b in cand[:j]) > 8
        assert scores[order[0]] - scores[order[1]] > 2 * SCORE_TOL, scores
        match = []
        for js, ja in jc:
            d = [np.abs(ja.astype(int) - c).max() for c in cand]
            assert min(d) <= 1, (i, d)
            match.append(int(order[int(np.argmin(d))]))
            assert abs(js - scores[match[-1]]) <= 0.005 + SCORE_TOL, (i, js, scores)
        assert sorted(match) == list(range(K))
        assert match[0] == got["selected"][i]
    lines_j = _result_lines(mid / f"{tag}_jax" / "dataset" / "result.txt")
    lines_p = _result_lines(mid / f"{tag}_port" / "dataset" / "result.txt")
    assert lines_p.keys() == lines_j.keys() == {"Best_PSNR", "Best_SSIM", "Best_UIQM",
                                                "Best_UCIQE"}
    for k, v in lines_j.items():
        assert lines_p[k] == pytest.approx(v, abs=1e-3 if "PSNR" in k else 2e-4), k
    assert f"{got['uiqm']:.4f}" == f"{lines_p['Best_UIQM']:.4f}"


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """pred / gt folders of 3 images each: PNG and JPEG mixed, 48x72."""
    root = tmp_path_factory.mktemp("folders")
    rng = np.random.default_rng(4)
    for d in ("pred", "gt"):
        os.makedirs(root / d)
    for i in range(3):
        gt = scene(20 + i, 48, 72)
        pred = np.clip(gt * rng.uniform(0.6, 1.4, 3) + rng.normal(0, 6, gt.shape), 0,
                       255).astype(np.uint8)
        ext = ".png" if i % 2 == 0 else ".jpg"
        cv2.imwrite(str(root / "gt" / f"{i}{ext}"), gt[..., ::-1])
        cv2.imwrite(str(root / "pred" / f"{i}{ext}"), pred[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    return root


def _printed(capsys):
    out = capsys.readouterr().out
    return {line.split(":")[0]: line.split(":")[1].split()[0] for line in out.splitlines()
            if ":" in line}


def test_eval_uciqe_uiqm_folder(folders, capsys):
    jax_folder.main([str(folders / "pred")])
    want = _printed(capsys)
    got = port_folder.main([str(folders / "pred"), "--device", "cpu"])
    assert _printed(capsys) == want and set(want) == {"Average UCIQE", "Average UIQM"}
    assert got[0] == pytest.approx(float(want["Average UCIQE"]), abs=5e-5)


@pytest.mark.parametrize("extra", [[], ["--GT_mean"], ["--lpips"]], ids=["plain", "GT_mean",
                                                                      "lpips"])
def test_cal_metrics_with_imgs(folders, capsys, tmp_path, monkeypatch, extra):
    if extra == ["--lpips"]:  # seeded AlexNet-shaped weights, as test_torch_eval_metrics.py
        rng, w = np.random.default_rng(5), {}
        for i, (o, c, k) in enumerate(_ALEX):
            bound = 1 / np.sqrt(c * k * k)
            w[f"conv{i + 1}.kernel"] = rng.uniform(-bound, bound, (k, k, c, o)).astype(np.float32)
            w[f"conv{i + 1}.bias"] = rng.uniform(-bound, bound, o).astype(np.float32)
            w[f"lin{i}.kernel"] = (np.abs(rng.standard_normal((1, 1, o, 1))) / o).astype(np.float32)
        np.savez(tmp_path / "lpips.npz", **w)
        monkeypatch.setenv("BEM_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    args = ["--pred_dir", str(folders / "pred"), "--gt_dir", str(folders / "gt")] + extra
    want = jax_cal.main(args)
    jprint = _printed(capsys)
    got = port_cal.main(args + ["--device", "cpu"])
    assert _printed(capsys) == jprint
    assert set(jprint) == {"PSNR", "SSIM"} | ({"LPIPS"} if extra == ["--lpips"] else set())
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-6)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-6)


def test_cal_metrics_unequal_folders_raise(folders, tmp_path):
    os.makedirs(tmp_path / "two")
    for f in sorted(os.listdir(folders / "gt"))[:2]:
        (tmp_path / "two" / f).write_bytes((folders / "gt" / f).read_bytes())
    with pytest.raises(ValueError, match="3 preds vs 2 gts"):
        port_cal.main(["--pred_dir", str(folders / "pred"), "--gt_dir", str(tmp_path / "two"),
                       "--device", "cpu"])

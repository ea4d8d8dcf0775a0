"""``--no_ref clip``: the port's eval CLI against bem_tpu's on a seeded
ViT-B/32 CLIP-IQA bundle (``smoke.write_clip_bundle``, the real shapes),
the tiny nets and inputs of test_torch_eval_cli.py, ``--deterministic``
and ``noise_level: 0``: the written images within 1 LSB; and the two
ClipIQA scorers (bem_tpu's as its main built it) on the same candidates
within 1e-4.
"""

import cv2
import numpy as np
import pytest
import torch

import bem_tpu.enhancement.clip_iqa as jax_clip_iqa
from bem_tpu.enhancement.eval import main as jax_main
from bem_tpu_torch import smoke
from bem_tpu_torch.enhancement.clip_iqa import ClipIQA
from bem_tpu_torch.enhancement.eval import main

from test_torch_eval_cli import _args, env, one_torch_thread  # noqa: F401  (fixtures)


@pytest.fixture(scope="module")
def clip_npz(tmp_path_factory):
    return str(smoke.write_clip_bundle(tmp_path_factory.mktemp("clip") / "vitb32.npz", seed=1))


def test_clip_selection_matches_bem_tpu(env, clip_npz, monkeypatch):  # noqa: F811
    monkeypatch.setenv("BEM_CLIP_NPZ", clip_npz)
    made = []  # bem_tpu's scorer as its main builds it, reused below (compiled for K=4)

    class Capture(jax_clip_iqa.ClipIQA):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(jax_clip_iqa, "ClipIQA", Capture)
    prompts = ["quality", "brightness"]
    extra = ["--no_ref", "clip", "--clip_prompts", *prompts]
    jax_main(_args(env, "clip_jax", "input128", extra))
    got = main(_args(env, "clip_port", "input128", extra + ["--device", "cpu"]))
    bests = []
    for i in range(2):
        a = cv2.imread(str(env / "clip_jax" / "dataset" / f"{i}.png"))
        b = cv2.imread(str(env / "clip_port" / "dataset" / f"{i}.png"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        bests.append(b[:, :, ::-1].astype(np.float32) / 255.0)
    assert got["selected"] == [0, 0]
    assert len(set(got["scores"][1])) == 1  # --deterministic: K equal candidates
    rng = np.random.default_rng(0)
    cands = np.stack(bests + [rng.random((128, 128, 3), np.float32) for _ in range(2)])
    want = np.asarray(made[0](cands))
    got_scores = ClipIQA(prompts, device="cpu").score(torch.from_numpy(cands)).numpy()
    np.testing.assert_allclose(got_scores, want, rtol=0, atol=1e-4)
    assert np.ptp(want) > 1e-4  # the scorer tells the candidates apart

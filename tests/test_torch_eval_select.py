"""The eval CLI's selection on K distinct candidates: bem_tpu's ``main``
against the port's, with Bayesian CG samples (no ``--deterministic``),
in the full-reference (``--GT_mean --Monte_Carlo --psnr_weight 0.5``),
niqe and clip modes, all with ``--save_candidates``.

The weight noise of every sample (K per image) is numpy-seeded and
injected into both CLIs: bem_tpu's ``_bayes_weight`` is monkeypatched (as
in test_torch_eval_kpipe.py) to read the eps of the sample whose key it
is given, found among the keys bem_tpu's main splits per image; the
port's ``sample_bayes`` takes the same eps in call order. Every image
either CLI writes is recorded. Checked per image: each side writes its
best image and then its candidates by descending score; the port's
``selected`` tops its own scores, and the top stands apart from the
next by more than twice the score tolerance; every candidate of
bem_tpu's is one of the port's within 1 LSB (they differ from each
other by more than 8), with its score (the file name's 2 decimals)
within that rounding plus the tolerance of the port's; bem_tpu's best is
the port's ``selected``. So an argmax for an argmin, a wrong
normalisation or a wrong rank order shows. Also the returned NIQE, PSNR
and SSIM and result.txt's lines, as in test_torch_eval_cli.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.enhancement.eval  # noqa: F401  (imports bem_tpu.utils.img_util)
import bem_tpu.nn.layers as jlayers
import bem_tpu.utils.img_util as jax_img_util
import bem_tpu_torch.enhancement.eval as port_eval
from bem_tpu.enhancement.eval import main as jax_main
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn.layers import sample_bayes

from test_torch_eval_cli import _result_lines, env, one_torch_thread  # noqa: F401  (fixtures)
from test_torch_eval_clip_cli import clip_npz  # noqa: F401  (a fixture)

K, P, SEED, NIMG = 4, 2, 3, 2
CFG = dict(type="Network", out_channels=3, n_feat=8, num_blocks=(1, 1), d_state=(1, 1),
           ssm_ratio=1, mlp_ratio=2, use_pixelshuffle=True, in_channels=3, bayesian=True)

MODES = {
    "full reference": ("input", ["--GT_mean", "--Monte_Carlo", "--psnr_weight", "0.5"]),
    "niqe": ("input128", ["--no_ref", "niqe"]),
    "clip": ("input128", ["--no_ref", "clip", "--clip_prompts", "quality", "brightness"]),
}
# how far the port's scores may sit from bem_tpu's: the PSNR / SSIM ratios;
# NIQE as chip_smoke holds the card to the CPU (its gamma fit is a table
# lookup: candidates within 1e-4 may move it by a step); CLIP's 1e-4
SCORE_TOL = {"full reference": 1e-4, "niqe": 5e-2, "clip": 1e-4}


@pytest.fixture(scope="module")
def mid(env):  # noqa: F811
    """The tiny CG and IE with 0.5 added to their output biases, saved by
    bem_tpu's ``save_params`` under ``mid_*.msgpack``: the seeded nets clamp
    a channel of some samples to 0 everywhere, where bem_tpu's GT-mean
    rescales give NaN (the deliberate difference, test_torch_eval_kpipe.py);
    centred on 0.5, no channel is."""
    from bem_tpu.utils.checkpoint import save_params

    for name, extra, seed in (("cg", {}, 0), ("ie", dict(in_channels=6, bayesian=False), 1)):
        net = build_network(dict(CFG, **extra), torch.Generator().manual_seed(seed))
        with torch.no_grad():
            net.proj.bias += 0.5
        save_params(str(env / f"mid_{name}.msgpack"), state_dict_to_flax(net))
    return env


def _args(root, out, inputs, extra):
    args = ["--opt", str(root / "cg.yml"), "--cond_opt", str(root / "ie.yml"),
            "--weights", str(root / "mid_cg.msgpack"),
            "--cond_weights", str(root / "mid_ie.msgpack"),
            "--input_dir", str(root / inputs), "--result_dir", str(root / out),
            "--num_samples", str(K), "--parallel_num", str(P), "--seed", str(SEED),
            "--save_candidates"] + extra
    if inputs == "input":
        args += ["--target_dir", str(root / "target")]
    return args


def _inject(monkeypatch):
    """Seeded eps for NIMG * K samples, injected into both CLIs."""
    cg = build_network(CFG, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(17)
    eps = [{k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            for k, p in cg.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
           for _ in range(NIMG * K)]
    eps_tree = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                      *[state_dict_to_flax(cg, e) for e in eps])
    # the sample keys of bem_tpu's main: per image key, sub = split(key), then
    # split(sub, K + 1)[1:] (make_k_pipeline's cg_samples)
    key, sample_keys = jax.random.PRNGKey(SEED), []
    for _ in range(NIMG):
        key, sub = jax.random.split(key)
        sample_keys.append(jax.random.key_data(jax.random.split(sub, K + 1)[1:]))
    sample_keys = jnp.concatenate(sample_keys)

    def bayes_weight(self, name, init_fn, shape, sigma_init):
        mu = self.param(f"mu_{name}", init_fn, shape)
        rho = self.param(f"rho_{name}", jlayers.inits.constant(
            jlayers.rho_from_sigma(sigma_init)), shape)
        if not self.has_rng("bayes"):
            return mu
        root_key = self.scope.rngs["bayes"]
        root_key = jax.random.key_data(getattr(root_key, "rng", root_key))
        k = jnp.argmax(jnp.all(root_key[None] == sample_keys, axis=-1))
        node = eps_tree
        for part in self.scope.path:
            node = node[part]
        return mu + jlayers.softplus_sigma(rho) * jnp.asarray(node[f"mu_{name}"])[k]

    draws = iter(eps)
    monkeypatch.setattr(jlayers._BayesParamMixin, "_bayes_weight", bayes_weight)
    monkeypatch.setattr(port_eval, "sample_bayes",
                        lambda net, gen=None, e=None: sample_bayes(net, gen, next(draws)))


def _record(monkeypatch, target, attr, bgr):
    """Record every image the CLI writes: [(file name, RGB uint8)]."""
    written, real = [], getattr(target, attr)

    def imwrite(img, path, *a, **k):
        written.append((os.path.basename(path), np.array(img[..., ::-1] if bgr else img)))
        return real(img, path, *a, **k)

    monkeypatch.setattr(target, attr, imwrite)
    return written


def _per_image(written):
    """Split the writes per image: (best image, [(score, candidate)] in rank order)."""
    out = []
    for name, img in written:
        stem = os.path.splitext(name)[0]
        if stem.isdigit():  # the input's own name: its best image, then its candidates
            out.append((img, []))
        else:
            out[-1][1].append((float(stem), img))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_selection_on_distinct_candidates(mid, clip_npz, monkeypatch, mode):  # noqa: F811
    monkeypatch.setenv("BEM_CLIP_NPZ", clip_npz)
    inputs, extra = MODES[mode]
    _inject(monkeypatch)
    tag = mode.replace(" ", "_")
    jw = _record(monkeypatch, jax_img_util, "imwrite", bgr=True)
    want = jax_main(_args(mid, f"sel_{tag}_jax", inputs, extra))
    pw = _record(monkeypatch, port_eval, "imwrite", bgr=False)
    got = port_eval.main(_args(mid, f"sel_{tag}_port", inputs, extra + ["--device", "cpu"]))

    jimgs, pimgs = _per_image(jw), _per_image(pw)
    assert len(jimgs) == len(pimgs) == NIMG
    for i, ((jbest, jc), (pbest, pc)) in enumerate(zip(jimgs, pimgs)):
        scores = np.array(got["scores"][i])
        order = np.argsort(scores)[::-1]
        assert len(jc) == len(pc) == K
        # each side writes its best image first, then its candidates by
        # descending score
        assert got["selected"][i] == order[0]
        assert [s for s, _ in pc] == [float(f"{v:.2f}") for v in scores[order]]
        assert [s for s, _ in jc] == sorted((s for s, _ in jc), reverse=True)
        np.testing.assert_array_equal(pbest, pc[0][1])
        np.testing.assert_array_equal(jbest, jc[0][1])
        # the candidates really differ, and the best stands apart from the rest
        cand = [c.astype(int) for _, c in pc]
        assert min(np.abs(a - b).max() for j, a in enumerate(cand) for b in cand[:j]) > 8
        assert scores[order[0]] - scores[order[1]] > 2 * SCORE_TOL[mode], scores
        # each of bem_tpu's candidates is one of the port's (1 LSB), scored alike
        match = []
        for js, ja in jc:
            d = [np.abs(ja.astype(int) - c).max() for c in cand]
            assert min(d) <= 1, (mode, i, d)
            match.append(int(order[int(np.argmin(d))]))
            assert abs(js - scores[match[-1]]) <= 0.005 + SCORE_TOL[mode], (mode, i, js, scores)
        assert sorted(match) == list(range(K))
        assert match[0] == got["selected"][i]  # bem_tpu picked the same candidate
    if mode == "niqe":
        assert got["niqe"] == pytest.approx(want["niqe"], rel=1e-3)
    if mode == "full reference":
        assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-3)
        assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-4)
        lines_j = _result_lines(mid / f"sel_{tag}_jax" / "dataset" / "result.txt")
        lines_p = _result_lines(mid / f"sel_{tag}_port" / "dataset" / "result.txt")
        assert lines_p.keys() == lines_j.keys() >= {"MC_PSNR", "MC_SSIM"}
        for k, v in lines_j.items():
            assert lines_p[k] == pytest.approx(v, abs=1e-3 if "PSNR" in k else 2e-4), k

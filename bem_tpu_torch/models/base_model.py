"""Base trainer: the network, its optimizer, schedule, EMA and Bayesian prior.

Counterpart of bem_tpu/models/base_model.py. JAX carries a functional
TrainState through a jitted step; here the trainer owns the module, an
explicit device and an explicit ``torch.Generator`` on it, and updates the
parameters in place (one copy of the weights instead of two). The
optimizer reproduces bem_tpu's optax chain (base_model.py:63-111):

    clip_by_global_norm(max_grad_norm) -> adamw(schedule, b1, b2, eps=1e-8,
                                                weight_decay)

- the clip scales by max_norm / ||g|| only when ||g|| >= max_norm (no
  epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
- AdamW decays every parameter, biases and LayerNorm weights included;
- the learning rate of update k (k = 0, 1, ...) is ``schedule(k)``;
- a net with ``frozen_subtrees`` (the Decomp family's ``decomp``) gets
  ``load_frozen`` when the trainer takes it (bem_tpu's ``init_state``),
  and the optimizer leaves those parameters alone: no update, no weight
  decay (bem_tpu's ``multi_transform`` with ``set_to_zero``). Their
  gradients are 0 (the frozen outputs carry none), so the clip's norm is
  the one over the trained parameters; Adam's moments of them stay 0.
- a batch with a MIM ``mask`` passes it to the forward while the step is
  within the scheduler's first period (bem_tpu's ``_use_mask``).

Checkpoints are bem_tpu's files (base_model.py:219-321): ``net_g_<iter>.msgpack``
and ``<iter>.state`` in flax's layout, through ``convert.py``'s per-leaf
transforms, so either package reads the other's. In a state the port keeps
its generator's state as uint8 in ``rng``; bem_tpu keeps a uint32 key there.
A net with ``frozen_subtrees`` writes and reads its optimizer state in the
layout of bem_tpu's ``multi_transform``: the chain under
``inner_states/train/inner_state``, an empty ``inner_states/frozen``, and
an empty dict (optax's ``MaskedNode``) at every frozen leaf of Adam's
moments.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..archs import build_network
from ..bayesian import extract_bayes_prior
from ..convert import flax_to_state_dict, state_dict_to_flax
from ..metrics import calculate_metric
from ..utils import checkpoint as ckpt
from ..utils.img_util import imwrite, tensor2img
from ..utils.logger import get_root_logger
from .lr_scheduler import build_schedule, with_warmup


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamWChain:
    """The optax chain of bem_tpu's trainers, over a {name: parameter} dict."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 max_norm: float = 0.0, frozen=()):
        self.schedule = schedule
        self.frozen = frozenset(frozen)  # names of parameters left as they are
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> float:
        """Apply one update in place; returns the learning rate used."""
        if self.max_norm:
            g_norm = global_norm(grads.values())
            scale = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                                self.max_norm / g_norm)
            grads = {k: g * scale for k, g in grads.items()}
        lr = float(self.schedule(self.count))
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            if k in self.frozen:
                continue
            g = grads[k]
            mu = self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu = self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u, alpha=-lr)
        return lr


class BaseModel:
    """Shared trainer skeleton; subclasses define ``train_step``.

    ``device`` is where the network, the batches and the generator live
    (CUDA unless the caller asks for the CPU); ``net`` is an already built
    network (e.g. with converted weights), else one is built from
    ``opt['network_g']`` with weights drawn from ``manual_seed``.
    """

    def __init__(self, opt: Dict[str, Any], device="cuda", net: Optional[torch.nn.Module] = None):
        self.opt = opt
        self.is_train = opt.get("is_train", False)
        self.logger = get_root_logger()
        self.device = torch.device(device)
        seed = opt.get("manual_seed") or 0
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        if net is None:
            net = build_network(opt["network_g"], torch.Generator().manual_seed(seed))
        if hasattr(net, "load_frozen"):
            net.load_frozen()
        self.net = net.to(self.device)
        self.params = dict(self.net.named_parameters())
        self.step = 0
        self.bayes_prior = extract_bayes_prior(self.params)
        self.ema_decay = 0.0
        self.ema_params = None
        self.metric_results: Dict[str, float] = {}
        self.last_visuals: Dict[str, torch.Tensor] = {}  # one train sample, for the dump
        if self.is_train:
            self._build_optimizer()

    def _build_optimizer(self):
        train_opt = self.opt["train"]
        optim_opt = dict(train_opt["optim_g"])
        optim_type = optim_opt.pop("type")
        base_lr = optim_opt.pop("lr")
        betas = optim_opt.pop("betas", (0.9, 0.999))
        wd = optim_opt.pop("weight_decay", 0.0)
        if optim_type != "AdamW":
            raise NotImplementedError(f"optimizer {optim_type} is not supported yet.")
        sched_opt = train_opt.get("scheduler")
        schedule = build_schedule(base_lr, sched_opt) if sched_opt else (lambda step: base_lr)
        self.lr_schedule = with_warmup(schedule, train_opt.get("warmup_iter", -1), base_lr)
        prefixes = tuple(p + "." for p in self._frozen_subtrees() or ())
        self.optimizer = AdamWChain(self.params, self.lr_schedule, betas[0], betas[1],
                                    weight_decay=wd, max_norm=train_opt.get("max_grad_norm", 0),
                                    frozen=[k for k in self.params if k.startswith(prefixes)])
        self.ema_decay = train_opt.get("ema_decay", 0)
        if self.ema_decay > 0:
            self.ema_params = {k: p.detach().clone() for k, p in self.params.items()}

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        """The array entries of ``batch`` as fp32 tensors on the device (the
        MIM mask too: it weighs the mask token)."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device, torch.float32)
        return out

    def _use_mask(self, batch) -> bool:
        """The MIM mask is used until the step passes the scheduler's first
        period (image_enhancer_model.py:169-170)."""
        if "mask" not in batch:
            return False
        periods = self.opt["train"].get("scheduler", {}).get("periods")
        return not (periods and self.step > periods[0])

    def _grads(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """d loss / d every parameter (zeros for one the loss does not reach)."""
        names = list(self.params)
        gs = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        return {k: torch.zeros_like(self.params[k]) if g is None else g
                for k, g in zip(names, gs)}

    def _apply_updates(self, grads, aux):
        """One optimizer step (+ EMA of the params); logs grad_norm and lr."""
        aux["grad_norm"] = global_norm(grads.values()).detach()
        aux["lr"] = self.optimizer.step(self.params, grads)
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, e in self.ema_params.items():
                    e.mul_(d).add_(self.params[k], alpha=1.0 - d)
        self.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}

    def _eval_state(self):
        """Parameter overrides of the deterministic forward: the EMA when kept."""
        return self.ema_params or {}

    # ------------------------------------------------------------ checkpoints
    def _flax(self, state=None, subset=False):
        return state_dict_to_flax(self.net, state, subset)

    def _load_flax(self, target: Dict[str, torch.Tensor], tree, what: str):
        """Copy a flax-layout tree into the tensors of ``target`` in place."""
        sd = flax_to_state_dict(tree)
        if set(sd) != set(target):
            raise ValueError(f"{what}: the checkpoint's names differ from the trainer's "
                             f"({sorted(set(sd) ^ set(target))[:4]} ...)")
        with torch.no_grad():
            for k, t in target.items():
                t.copy_(torch.from_numpy(np.array(sd[k], copy=True)))

    def _frozen_subtrees(self):
        """The net's frozen top-level names, or None for a net without any."""
        return tuple(self.net.frozen_subtrees()) if hasattr(self.net, "frozen_subtrees") else None

    def train_state(self) -> dict:
        """bem_tpu's ``TrainState`` tree: step, params, opt_state (the optax
        chain [clip_by_global_norm], adamw: ({}, ((count, mu, nu), {},
        (count,))), inside ``multi_transform``'s layout for a net with
        frozen subtrees), rng, ema_params, bayes_prior."""
        opt = self.optimizer
        count = np.asarray(opt.count, np.int32)
        frozen = self._frozen_subtrees()
        mu, nu = self._flax(opt.mu), self._flax(opt.nu)
        for tree in (mu, nu):
            for name in frozen or ():
                tree[name] = _masked(tree[name])
        adamw = {"0": {"count": count, "mu": mu, "nu": nu}, "1": {}, "2": {"count": count}}
        chain = ([{}] if opt.max_norm else []) + [adamw]
        opt_state = {str(i): c for i, c in enumerate(chain)}
        if frozen is not None:
            opt_state = {"inner_states": {"train": {"inner_state": opt_state},
                                          "frozen": {"inner_state": {}}}}
        return {"step": np.asarray(self.step, np.int32), "params": self._flax(),
                "opt_state": opt_state,
                "rng": self.gen.get_state().numpy(),
                "ema_params": None if self.ema_params is None else self._flax(self.ema_params),
                "bayes_prior": (None if self.bayes_prior is None
                                else self._flax(self.bayes_prior, subset=True))}

    def load_train_state(self, tree: dict, source: str = "the state"):
        """Take up a ``train_state`` tree, the port's or bem_tpu's."""
        step = int(tree["step"])
        chain = tree["opt_state"]
        partitioned = "inner_states" in chain
        if partitioned != (self._frozen_subtrees() is not None):
            raise ValueError(f"{source}: its optimizer state {'is' if partitioned else 'is not'} "
                             f"partitioned into trained and frozen parameters, and this net "
                             f"{'has no' if partitioned else 'has'} frozen subtrees")
        if partitioned:
            chain = chain["inner_states"]["train"]["inner_state"]
        self._load_flax(self.params, tree["params"], f"{source} params")
        adam = chain[str(len(chain) - 1)]["0"]
        opt = self.optimizer
        opt.count = int(adam["count"])
        for what, moments in (("mu", opt.mu), ("nu", opt.nu)):
            # frozen leaves are empty (MaskedNode) and their moments stay 0
            self._load_flax({k: t for k, t in moments.items() if k not in opt.frozen},
                            adam[what], f"{source} Adam {what}")
            for k in opt.frozen:
                moments[k].zero_()
        if tree.get("ema_params") is not None:
            if self.ema_params is None:
                self.ema_params = {k: torch.empty_like(p) for k, p in self.params.items()}
            self._load_flax(self.ema_params, tree["ema_params"], f"{source} EMA params")
        if tree.get("bayes_prior") is not None:
            self.bayes_prior = {k: torch.from_numpy(np.array(v, copy=True)).to(self.device)
                                for k, v in flax_to_state_dict(tree["bayes_prior"]).items()}
        rng = np.asarray(tree["rng"])
        if rng.dtype == np.uint8 and rng.size == self.gen.get_state().numel():
            self.gen.set_state(torch.from_numpy(rng.copy()))
        else:
            seed = (self.opt.get("manual_seed") or 0) + step
            self.gen.manual_seed(seed)
            self.logger.warning(f"{source}: its rng ({rng.dtype} {rng.shape}) is not this "
                                f"trainer's generator state (bem_tpu's key, or a generator on "
                                f"another device); the noise stream restarts from manual_seed "
                                f"+ step = {seed}.")
        self.step = step

    def _paths(self):
        root = self.opt["path"]["experiments_root"]
        return os.path.join(root, "models"), os.path.join(root, "training_states")

    def save(self, epoch: int, current_iter: int, **kwargs):
        """net_g_<iter>.msgpack (params, and params_ema when kept) and
        <iter>.state (base_model.py:223)."""
        mdir, sdir = self._paths()
        extra = None if self.ema_params is None else {"params_ema": self._flax(self.ema_params)}
        ckpt.save_params(os.path.join(mdir, f"net_g_{current_iter}.msgpack"), self._flax(),
                         extra=extra)
        ckpt.save_state(os.path.join(sdir, f"{current_iter}.state"), self.train_state())

    def save_best(self, best_metric: Dict[str, Any], param_key: str = "params"):
        """best_psnr_<psnr:.2f>_<iter>.msgpack in the experiment's root, the
        older best files removed (base_model.py:235)."""
        root = self.opt["path"]["experiments_root"]
        path = os.path.join(root, f"best_psnr_{best_metric['psnr']:.2f}_{best_metric['iter']}.msgpack")
        if not os.path.exists(path):
            for f in glob.glob(os.path.join(root, "best_*")):
                os.remove(f)
            ckpt.save_params(path, self._flax(), param_key)

    def resume_training(self, state_path: str):
        self.load_train_state(ckpt.load_state(state_path), state_path)
        self.logger.info(f"Resumed training from {state_path} (iter {self.step}).")

    def load_network(self, load_path: str, strict: bool = True, param_key: str = "params"):
        """Load a net_g file's ``param_key`` tree (base_model.py:253). Every
        missing, unexpected or size-mismatched leaf is logged; strict raises
        on any, non-strict keeps the trainer's value for those leaves."""
        params = ckpt.load_params(load_path, param_key)
        ref, new = _leaves(self._flax()), _leaves(params)
        missing = sorted(set(ref) - set(new))
        unexpected = sorted(set(new) - set(ref))
        mismatched = sorted(k for k in set(ref) & set(new)
                            if tuple(ref[k].shape) != tuple(new[k].shape))
        for k in missing:
            self.logger.warning(f"load_network: missing key {k}")
        for k in unexpected:
            self.logger.warning(f"load_network: unexpected key {k}")
        for k in mismatched:
            self.logger.warning(f"load_network: size mismatch {k}: model "
                                f"{tuple(ref[k].shape)} vs ckpt {tuple(new[k].shape)}")
        if strict and (missing or unexpected or mismatched):
            raise ValueError(f"load_network(strict=True) from {load_path}: {len(missing)} "
                             f"missing, {len(unexpected)} unexpected, {len(mismatched)} "
                             f"size-mismatched keys (see log).")
        merged = {k: (new[k] if k in new and k not in mismatched else v) for k, v in ref.items()}
        self._load_flax(self.params, _unflatten(merged), load_path)
        self.logger.info(f"Loaded network weights from {load_path} [{param_key}].")

    def sigma_logs(self) -> Dict[str, float]:
        """Mean |softplus(rho)| of every Bayesian rho tensor, tagged
        vars/<flax path> with rho_ -> sigma_ (base_model.py:177)."""
        rho = {k: p for k, p in self.params.items() if k.rpartition(".")[2].startswith("rho_")}
        tree = self._flax(rho, subset=True) if rho else {}
        return {"vars/" + "|".join(path).replace("rho_", "sigma_"):
                float(np.mean(np.abs(F.softplus(torch.from_numpy(v)).numpy())))
                for path, v in _paths(tree)}

    # ------------------------------------------------------------ validation
    def validation(self, dataloader, current_iter, tb_logger=None, save_img=False,
                   rgb2bgr=True, use_image=True):
        return self.nondist_validation(dataloader, current_iter, tb_logger, save_img,
                                       rgb2bgr, use_image)

    def nondist_validation(self, dataloader, current_iter, tb_logger=None, save_img=False,
                           rgb2bgr=True, use_image=True):
        """Mean of each ``val.metrics`` entry over the loader's images; logs
        them and returns the PSNR (image_enhancer_model.py:131,
        condition_generator_model.py:144). The metrics see what bem_tpu's
        see: the uint8 output, BGR when ``rgb2bgr``."""
        dataset_name = dataloader.dataset.opt["name"]
        metrics_opt = self.opt["val"].get("metrics")
        self.metric_results = {m: 0.0 for m in (metrics_opt or {})}
        window_size = self.opt["val"].get("window_size", 0)
        cnt = 0
        for val_data in dataloader:
            output, gt = self._val_forward(val_data, window_size)
            sr_img = tensor2img(output[0].float().cpu().numpy(), rgb2bgr=rgb2bgr)
            gt_img = None if gt is None else tensor2img(gt[0], rgb2bgr=rgb2bgr)
            if save_img:
                # bem_tpu hands these images to cv2.imwrite, which reads them as BGR
                name = os.path.splitext(os.path.basename(val_data["lq_path"][0]))[0]
                vis = self.opt["path"].get("visualization", ".")
                for suffix, img in zip(("", "_gt"), self._val_images_to_save(sr_img, gt_img)):
                    if img is not None:
                        imwrite(img[..., ::-1], os.path.join(vis, name, f"{name}{suffix}.png"))
            if metrics_opt and gt_img is not None:
                for mname, mopt in metrics_opt.items():
                    self.metric_results[mname] += calculate_metric({"img": sr_img, "img2": gt_img},
                                                                   mopt)
            cnt += 1
        for m in self.metric_results:
            self.metric_results[m] /= max(cnt, 1)
        self._log_validation_metric_values(current_iter, dataset_name, tb_logger)
        return self.metric_results.get("psnr", 0.0)

    def _val_forward(self, val_data, window_size: int):
        """(the deterministic forward's output, the target or None) of one
        validation batch."""
        raise NotImplementedError

    def _val_images_to_save(self, sr_img, gt_img):
        return sr_img, gt_img

    def _log_validation_metric_values(self, current_iter, dataset_name, tb_logger):
        log_str = f"Validation {dataset_name},\t"
        for metric, value in self.metric_results.items():
            log_str += f"\t # {metric}: {value:.4f}"
        self.logger.info(log_str)
        if tb_logger:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f"metrics/{metric}", value, current_iter)


def reflect_pad(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) reflect-padded at the bottom and right to multiples of
    ``window_size``."""
    pad = (0, (-x.shape[2]) % window_size, 0, (-x.shape[1]) % window_size)
    return F.pad(x.permute(0, 3, 1, 2), pad, mode="reflect").permute(0, 2, 3, 1)


def _masked(tree: dict) -> dict:
    """``tree`` with every leaf an empty dict (how flax writes optax's MaskedNode)."""
    return {k: _masked(v) if isinstance(v, dict) else {} for k, v in tree.items()}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaves(tree) -> Dict[str, np.ndarray]:
    """{jax keystr of the path, e.g. "['proj']['bias']": leaf}."""
    return {"".join(f"[{k!r}]" for k in path): v for path, v in _paths(tree)}


def _unflatten(leaves: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in leaves.items():
        *head, leaf = key[2:-2].split("']['")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree

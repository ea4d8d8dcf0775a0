"""LQ-only dataset for inference sets without GT (counterpart of
bem_tpu/data/single_image_dataset.py)."""

from __future__ import annotations

import numpy as np

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from .data_util import scandir


class SingleImageDataset:
    """Every file of ``dataroot_lq`` (sorted full paths), or the names listed
    first on each line of ``meta_info_file``; a sample is {lq, lq_path},
    normalised by ``mean`` / ``std`` where given (single_image_dataset.py:14)."""

    def __init__(self, opt):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.mean, self.std = opt.get("mean"), opt.get("std")
        self.lq_folder = opt["dataroot_lq"]
        if self.io_backend_opt["type"] == "lmdb":
            raise NotImplementedError("the lmdb io_backend is not ported (disk is)")
        if opt.get("meta_info_file") is not None:
            with open(opt["meta_info_file"]) as f:
                self.paths = [f"{self.lq_folder}/{line.rstrip().split(' ')[0]}" for line in f]
        else:
            self.paths = sorted(scandir(self.lq_folder, full_path=True))

    def __getitem__(self, index):
        if self.file_client is None:
            io_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(io_opt.pop("type"), **io_opt)
        lq_path = self.paths[index]
        img_lq = img2tensor(imfrombytes(self.file_client.get(lq_path, "lq"), float32=True,
                                        name=lq_path))
        if self.mean is not None or self.std is not None:
            img_lq = (img_lq - np.asarray(self.mean or 0.0, np.float32)) / np.asarray(
                self.std or 1.0, np.float32)
        return {"lq": img_lq, "lq_path": lq_path}

    def __len__(self):
        return len(self.paths)

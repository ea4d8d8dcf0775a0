"""Datasets, the sampler, the threaded loader and the prefetchers
(counterpart of bem_tpu/data/__init__.py:35-231).

The loader is bem_tpu's, not ``torch.utils.data.DataLoader``: a thread pool
decodes ahead of the consumer (image decoding and numpy release the GIL),
the sampler's epoch-seeded order and ``drop_last`` decide the batches, and
a batch is a dict of stacked numpy arrays (lists for the paths).
``DevicePrefetcher`` copies pinned host batches to the card on a side
stream, so the copy of batch i + 1 overlaps step i.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from .paired_image_dataset import Dataset_PairedImage, Dataset_PairedImage_Mask

DATASETS = {"Dataset_PairedImage": Dataset_PairedImage,
            "Dataset_PairedImage_Mask": Dataset_PairedImage_Mask}

__all__ = ["build_dataset", "build_dataloader", "EnlargedSampler", "DataLoader",
           "CPUPrefetcher", "DevicePrefetcher", "Dataset_PairedImage",
           "Dataset_PairedImage_Mask"]


def build_dataset(dataset_opt: Dict[str, Any]):
    if dataset_opt["type"] not in DATASETS:
        raise NotImplementedError(f"dataset {dataset_opt['type']} is not ported "
                                  f"(ported: {sorted(DATASETS)})")
    return DATASETS[dataset_opt["type"]](dict(dataset_opt))


class EnlargedSampler:
    """Per-rank strided indices over the dataset enlarged by ``ratio``,
    shuffled by a generator seeded with (seed, epoch) (__init__.py:42)."""

    def __init__(self, num_samples: int, num_replicas: int = 1, rank: int = 0,
                 ratio: int = 1, seed: int = 0):
        self.dataset_len = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.seed = seed or 0
        self.num_samples = int(np.ceil(num_samples * ratio / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        g = np.random.default_rng((self.seed, self.epoch))
        indices = [i % self.dataset_len for i in g.permutation(self.total_size).tolist()]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self):
        return self.num_samples


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Map-style loader yielding stacked-numpy batches; ``num_workers``
    threads decode up to ``prefetch_batches`` batches ahead (__init__.py:84)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 sampler: Optional[EnlargedSampler] = None, num_workers: int = 0,
                 drop_last: bool = False, seed: Optional[int] = None,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self._epoch = 0

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.default_rng(None if self.seed is None else self.seed + self._epoch
                                  ).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers <= 0:
            for b in batches:
                yield _collate([self.dataset[i] for i in b])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = queue.Queue()

            def submit(b):
                pending.put([pool.submit(self.dataset.__getitem__, i) for i in b])

            it = iter(batches)
            for _ in range(max(1, self.prefetch_batches)):
                b = next(it, None)
                if b is not None:
                    submit(b)
            while not pending.empty():
                futs = pending.get()
                b = next(it, None)
                if b is not None:
                    submit(b)
                yield _collate([f.result() for f in futs])


def build_dataloader(dataset, dataset_opt: Dict[str, Any], num_gpu: int = 1,
                     dist: bool = False, sampler=None, seed=None) -> DataLoader:
    """Train: batch_size_per_gpu x num_gpu, num_worker_per_gpu threads,
    drop_last; val / test: batch 1, no threads (__init__.py:167)."""
    phase = dataset_opt["phase"]
    if phase == "train":
        return DataLoader(dataset, batch_size=dataset_opt.get("batch_size_per_gpu", 1)
                          * max(num_gpu, 1),
                          shuffle=(sampler is None) and dataset_opt.get("use_shuffle", True),
                          sampler=sampler, num_workers=dataset_opt.get("num_worker_per_gpu", 0),
                          drop_last=True, seed=seed)
    if phase in ("val", "test"):
        return DataLoader(dataset, batch_size=1, shuffle=False, num_workers=0)
    raise ValueError(f"Wrong dataset phase: {phase}")


class CPUPrefetcher:
    """Restartable iterator over host batches (__init__.py:193)."""

    def __init__(self, loader: DataLoader):
        self.ori_loader = loader
        self.loader = iter(loader)

    def next(self):
        return next(self.loader, None)

    def reset(self):
        self.loader = iter(self.ori_loader)


class DevicePrefetcher:
    """Double-buffered copy to a CUDA device: each batch's arrays are pinned
    and copied on a side stream while the previous batch is in use
    (__init__.py:209, BasicSR's CUDAPrefetcher)."""

    def __init__(self, loader: DataLoader, device="cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"prefetch_mode 'device' copies batches to a CUDA device, "
                             f"not {self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self.ori_loader = loader
        self.reset()

    def _put(self, batch):
        if batch is None:
            return None
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray) and v.dtype != object:
                    v = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    v = v.to(self.device, non_blocking=True)
                out[k] = v
        return out

    def next(self):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_stream(self.stream)
        current = self.batch
        for v in (current or {}).values():
            if isinstance(v, torch.Tensor):
                v.record_stream(stream)
        self.batch = self._put(next(self.loader, None))
        return current

    def reset(self):
        self.loader = iter(self.ori_loader)
        self.batch = self._put(next(self.loader, None))

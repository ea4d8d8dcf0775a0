"""Path pairing (counterpart of bem_tpu/data/data_util.py)."""

from __future__ import annotations

import os
from os import path as osp
from typing import List


def scandir(dir_path):
    """The names of the non-hidden files in ``dir_path`` (data_util.py:13)."""
    return (e.name for e in os.scandir(dir_path) if not e.name.startswith(".") and e.is_file())


def paired_paths_from_folder(folders: List[str], keys: List[str], filename_tmpl: str):
    """Pair the files of (input folder, GT folder) by the GT file's stem
    through ``filename_tmpl``, by sorted index where no such input file
    exists (data_util.py:31)."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = sorted(scandir(input_folder))
    gt_paths = sorted(scandir(gt_folder))
    assert len(input_paths) == len(gt_paths), (
        f"{input_key} and {gt_key} datasets have different number of images: "
        f"{len(input_paths)}, {len(gt_paths)}.")
    paths = []
    for gt_path in gt_paths:
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_path = osp.join(input_folder, f"{filename_tmpl.format(basename)}{ext}")
        if not osp.exists(input_path):
            input_path = osp.join(input_folder, input_paths[len(paths)])
        paths.append({f"{input_key}_path": input_path,
                      f"{gt_key}_path": osp.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file, filename_tmpl):
    """Pairs from the GT names listed first on each line of
    ``meta_info_file`` (data_util.py:56)."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, "r") as f:
        gt_names = [line.strip().split(" ")[0] for line in f if line.strip()]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        paths.append({f"{input_key}_path": osp.join(input_folder,
                                                    f"{filename_tmpl.format(basename)}{ext}"),
                      f"{gt_key}_path": osp.join(gt_folder, gt_name)})
    return paths

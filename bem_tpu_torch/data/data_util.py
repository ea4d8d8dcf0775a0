"""Path scanning and pairing (counterpart of bem_tpu/data/data_util.py)."""

from __future__ import annotations

import os
from os import path as osp
from typing import List


def scandir(dir_path, suffix=None, recursive: bool = False, full_path: bool = False):
    """The non-hidden files under ``dir_path`` (data_util.py:13): their paths
    relative to it (or full, ``full_path``), those ending with ``suffix``
    (a string or a tuple) where given, into subfolders where ``recursive``."""
    if isinstance(suffix, str):
        suffix = (suffix,)

    def scan(d):
        for entry in os.scandir(d):
            if not entry.name.startswith(".") and entry.is_file():
                rel = entry.path if full_path else osp.relpath(entry.path, dir_path)
                if suffix is None or rel.endswith(tuple(suffix)):
                    yield rel
            elif recursive and entry.is_dir():
                yield from scan(entry.path)

    return scan(dir_path)


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


def paired_DP_paths_from_folder(folders, keys, filename_tmpl):
    """(left input, right input, GT) triples by the GT file's stem, each
    input taking the extension of the file at the same sorted index
    (data_util.py:94)."""
    assert len(folders) == 3 and len(keys) == 3
    left_folder, right_folder, gt_folder = folders
    left_paths = sorted(scandir(left_folder))
    right_paths = sorted(scandir(right_folder))
    gt_paths = sorted(scandir(gt_folder))
    assert len(left_paths) == len(right_paths) == len(gt_paths), (
        f"{keys} datasets have different number of images: "
        f"{len(left_paths)}, {len(right_paths)}, {len(gt_paths)}.")
    paths = []
    for idx, gt_path in enumerate(gt_paths):
        basename, _ = osp.splitext(osp.basename(gt_path))
        names = []
        for listed, key in ((left_paths, keys[0]), (right_paths, keys[1])):
            name = f"{filename_tmpl.format(basename)}{osp.splitext(listed[idx])[1]}"
            assert name in listed, f"{name} is not in {key}_paths."
            names.append(name)
        paths.append({f"{keys[0]}_path": osp.join(left_folder, names[0]),
                      f"{keys[1]}_path": osp.join(right_folder, names[1]),
                      f"{keys[2]}_path": osp.join(gt_folder, gt_path)})
    return paths

"""Eval-server submission packagers for GOT-10k and TrackingNet, a copy of
mmtrack_tpu/eval/submission.py (tests/test_torch_host_tools.py holds its
zips equal to the JAX module's, member by member).

Rebuilds the reference's transform scripts
(RGBD/models/OSTrack/lib/test/utils/transform_got10k.py:9-42 and
transform_trackingnet.py:9-31) over the OPE result layout
(eval/ope.py::result_path -> <results_root>/<dataset>/<config>/<seq>.txt):

- GOT-10k: each sequence becomes its own subdirectory holding
  ``<seq>_001.txt`` (comma-separated ints) plus the verbatim-copied
  ``<seq>_time.txt``; both the raw and the submit tree are zipped and the
  unzipped trees removed.
- TrackingNet: a flat directory of ``<seq>.txt`` files rewritten to
  comma-separated ints (the server ignores timing files); zipped the same
  way.

Box re-formatting matches the reference exactly: values are loaded and
``astype(int)``-truncated (transform_got10k.py:29 loads ``dtype=np.int``),
then written ``fmt='%d', delimiter=','`` (line 30). Sources are read
tolerantly (tab - the pytracking save_bb format - first, then comma, then
whitespace) so results written by either ``save_fmt`` pass through.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

__all__ = ["transform_got10k", "transform_trackingnet"]


def _load_boxes_int(path: str) -> np.ndarray:
    for delim in ("\t", ",", None):
        try:
            arr = np.loadtxt(path, delimiter=delim, dtype=np.float64)
            if arr.size:
                return arr.reshape(-1, 4).astype(int)
        except ValueError:
            continue
    raise ValueError(f"could not parse result file {path}")


def _finalize(src_dir: str, dest_dir: str, cleanup: bool) -> tuple[str, str]:
    # reference: zip BOTH the raw results and the submit tree, then remove
    # the unzipped originals (transform_got10k.py:37-42)
    src_zip = shutil.make_archive(src_dir.rstrip("/"), "zip", src_dir)
    dest_zip = shutil.make_archive(dest_dir.rstrip("/"), "zip", dest_dir)
    if cleanup:
        shutil.rmtree(src_dir)
        shutil.rmtree(dest_dir)
    return src_zip, dest_zip


def transform_got10k(results_root: str, config_name: str,
                     dataset: str = "got10k", cleanup: bool = True
                     ) -> tuple[str, str]:
    """Package <results_root>/<dataset>/<config_name>/ for the GOT-10k eval
    server. Returns (raw_zip, submit_zip) paths."""
    src_dir = os.path.join(results_root, dataset, config_name)
    dest_dir = os.path.join(results_root, dataset + "_submit", config_name)
    os.makedirs(dest_dir, exist_ok=True)
    for item in sorted(os.listdir(src_dir)):
        if "all" in item:  # transform_got10k.py:18-19
            continue
        src_path = os.path.join(src_dir, item)
        if item.endswith("_time.txt"):
            seq_name = item[: -len("_time.txt")]
            seq_dir = os.path.join(dest_dir, seq_name)
            os.makedirs(seq_dir, exist_ok=True)
            shutil.copyfile(src_path, os.path.join(seq_dir, item))
        elif item.endswith("_time.value"):
            # this repo's default timing companion: convert to the
            # reference save_time format ('%f', running.py:30-32)
            seq_name = item[: -len("_time.value")]
            seq_dir = os.path.join(dest_dir, seq_name)
            os.makedirs(seq_dir, exist_ok=True)
            times = np.loadtxt(src_path, dtype=np.float64).reshape(-1)
            np.savetxt(os.path.join(seq_dir, seq_name + "_time.txt"),
                       times, delimiter="\t", fmt="%f")
        elif item.endswith(".value"):
            continue  # confidence companions are not part of the submission
        elif item.endswith(".txt"):
            seq_name = item[:-4]
            seq_dir = os.path.join(dest_dir, seq_name)
            os.makedirs(seq_dir, exist_ok=True)
            np.savetxt(os.path.join(seq_dir, seq_name + "_001.txt"),
                       _load_boxes_int(src_path), fmt="%d", delimiter=",")
    return _finalize(src_dir, dest_dir, cleanup)


def transform_trackingnet(results_root: str, config_name: str,
                          dataset: str = "trackingnet", cleanup: bool = True
                          ) -> tuple[str, str]:
    """Package <results_root>/<dataset>/<config_name>/ for the TrackingNet
    eval server (flat <seq>.txt files, comma ints; timing files skipped —
    transform_trackingnet.py:17-25). Returns (raw_zip, submit_zip)."""
    src_dir = os.path.join(results_root, dataset, config_name)
    dest_dir = os.path.join(results_root, dataset + "_submit", config_name)
    os.makedirs(dest_dir, exist_ok=True)
    for item in sorted(os.listdir(src_dir)):
        if "all" in item or "time" in item or item.endswith(".value"):
            continue
        if item.endswith(".txt"):
            np.savetxt(os.path.join(dest_dir, item),
                       _load_boxes_int(os.path.join(src_dir, item)),
                       fmt="%d", delimiter=",")
    return _finalize(src_dir, dest_dir, cleanup)

"""NYUv2 dataset download/prep helpers (reference ``src/data.py:1144-1277``).

Produce the ``{train,test}_{rgb,seg13,sn,depth}`` folder layout the ``NYUv2``
reader consumes. Downloads fail fast with the URL printed when the
environment has no egress (the reference wget/requests them); all local
processing — unpack, rename, split, 16-bit depth PNG extraction from the
official labelled ``.mat`` (h5py) — is fully implemented so a user can drop
the archives in ``root`` and run the same prep.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import zipfile

import numpy as np
from PIL import Image

RGB_URLS = {
    "train": "http://www.doc.ic.ac.uk/~ahanda/nyu_train_rgb.tgz",
    "test": "http://www.doc.ic.ac.uk/~ahanda/nyu_test_rgb.tgz",
}
SEG_URLS = {
    "train": ("https://github.com/ankurhanda/nyuv2-meta-data/raw/master/"
              "train_labels_13/nyuv2_train_class13.tgz"),
    "test": ("https://github.com/ankurhanda/nyuv2-meta-data/raw/master/"
             "test_labels_13/nyuv2_test_class13.tgz"),
}
SN_URL = "https://www.dropbox.com/s/dn5sxhlgml78l03/nyu_normals_gt.zip"
DEPTH_MAT_URL = ("http://horatio.cs.nyu.edu/mit/silberman/nyu_depth_v2/"
                 "nyu_depth_v2_labeled.mat")


def _download(url: str, dst_dir: str) -> str:
    """Fetch url into dst_dir; raises with the URL on zero-egress hosts."""
    import urllib.request

    os.makedirs(dst_dir, exist_ok=True)
    tar = os.path.join(dst_dir, url.split("/")[-1].split("?")[0])
    if os.path.exists(tar):
        return tar
    try:
        urllib.request.urlretrieve(url, tar)
    except Exception as e:  # noqa: BLE001 — report URL for manual fetch
        raise RuntimeError(
            f"cannot download {url} (no egress?): fetch it manually into "
            f"{dst_dir} and re-run") from e
    return tar


def _unpack(file: str) -> None:
    """Unpack tar/zip next to the archive (reference ``_unpack``)."""
    path = file.rsplit(".", 1)[0]
    if file.endswith(".tgz"):
        with tarfile.open(file, "r:gz") as tar:
            tar.extractall(path)
    elif file.endswith(".zip"):
        with zipfile.ZipFile(file, "r") as z:
            z.extractall(path)


def _rename_files(folder: str, rename_func) -> None:
    for old in os.listdir(folder):
        shutil.move(os.path.join(folder, old),
                    os.path.join(folder, rename_func(old)))


def _replace_folder(src: str, dst: str) -> None:
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.move(src, dst)


def _proc_archive(url: str, root: str, dst: str, rename_func) -> None:
    if os.path.exists(dst):
        return
    tar = _download(url, root)
    _unpack(tar)
    _replace_folder(tar.rstrip(".tgz"), dst)
    _rename_files(dst, rename_func)


def download_rgb(root: str) -> None:
    # archive files are named like nyu_rgb_0001.png -> 0001.png
    for split, url in RGB_URLS.items():
        _proc_archive(url, root, os.path.join(root, f"{split}_rgb"),
                      lambda x: x.split("_")[2])


def download_seg(root: str) -> None:
    # new_nyu_class13_0001.png -> 0001.png
    for split, url in SEG_URLS.items():
        _proc_archive(url, root, os.path.join(root, f"{split}_seg13"),
                      lambda x: x.split("_")[3])


def download_sn(root: str) -> None:
    train_dst = os.path.join(root, "train_sn")
    test_dst = os.path.join(root, "test_sn")
    if os.path.exists(train_dst) and os.path.exists(test_dst):
        return
    tar = _download(SN_URL + "?dl=1", root)
    _unpack(tar)
    unpacked = os.path.join(root, "nyu_normals_gt")
    if not os.path.exists(unpacked):  # zip unpacks next to archive
        unpacked = os.path.join(tar.rsplit(".", 1)[0], "nyu_normals_gt")
    if not os.path.exists(train_dst):
        _replace_folder(os.path.join(unpacked, "train"), train_dst)
        _rename_files(train_dst, lambda x: x[1:])
    if not os.path.exists(test_dst):
        _replace_folder(os.path.join(unpacked, "test"), test_dst)
        _rename_files(test_dst, lambda x: x[1:])
    shutil.rmtree(unpacked, ignore_errors=True)


def create_depth_files(mat_file: str, root: str, train_ids) -> None:
    """16-bit depth PNGs (depth*1e4, transposed) split by train ids
    (reference ``_create_depth_files``, ``src/data.py:1258-1277``)."""
    import h5py

    os.makedirs(os.path.join(root, "train_depth"), exist_ok=True)
    os.makedirs(os.path.join(root, "test_depth"), exist_ok=True)
    train_ids = set(train_ids)
    with h5py.File(mat_file, "r") as f:
        depths = f["depths"]
        for i in range(len(depths)):
            img = (depths[i] * 1e4).astype(np.uint16).T
            id_ = str(i + 1).zfill(4)
            folder = "train" if id_ in train_ids else "test"
            Image.fromarray(img).save(
                os.path.join(root, f"{folder}_depth", id_ + ".png"))


def download_depth(root: str) -> None:
    if (os.path.exists(os.path.join(root, "train_depth"))
            and os.path.exists(os.path.join(root, "test_depth"))):
        return
    mat = _download(DEPTH_MAT_URL, root)
    train_ids = [f.split(".")[0]
                 for f in os.listdir(os.path.join(root, "train_rgb"))]
    create_depth_files(mat, root, train_ids)


def prepare_nyuv2(root: str) -> None:
    """Full prep: rgb + seg13 + surface normals + depth."""
    download_rgb(root)
    download_seg(root)
    download_sn(root)
    download_depth(root)

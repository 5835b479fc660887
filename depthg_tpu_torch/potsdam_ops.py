"""Potsdam/COCO auxiliary data ops (reference ``potsdam_ops.py``, torch-free).

Tasks:
* ``convert_mat`` — Potsdam .mat tiles -> RGB PNGs;
* ``convert_coco_depth_map`` — resize depth samples to 224 and apply per-type
  post-processing (kbr: channel-mean + min-max + invert; midas/zoedepth:
  invert);
* ``match_images`` — exact-match dedup between two .mat folders, copying the
  matched renamed PNGs.
"""

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from PIL import Image


def _load_mat_img(path):
    from scipy.io import loadmat

    return np.asarray(loadmat(path)["img"])[:, :, :3].astype(np.uint8)


def convert_mat(args):
    os.makedirs(args.output_dir, exist_ok=True)
    for file in sorted(os.listdir(args.folder)):
        try:
            img = _load_mat_img(os.path.join(args.folder, file))
        except Exception:
            print("Error loading file:", file)
            continue
        Image.fromarray(img).save(os.path.join(args.output_dir, file[:-4] + ".png"))
    print("Done!")


def convert_coco_depth_map(args):
    output_dir = os.path.join(args.folder, "processed")
    os.makedirs(output_dir, exist_ok=True)
    for file in sorted(os.listdir(args.folder)):
        path = os.path.join(args.folder, file)
        if not os.path.isfile(path):
            continue
        img = Image.open(path).resize((224, 224))
        arr = np.asarray(img).astype(np.float32)
        if arr.max() > 1:
            arr = arr / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        else:
            arr = arr[None]
        if "kbr" in file:
            arr = arr.mean(0, keepdims=True)
            arr = (arr - arr.min()) / max(arr.max() - arr.min(), 1e-12)
            arr = 1 - arr
        elif "midas" in file or "zoedepth" in file:
            arr = 1 - arr
        out = (np.clip(arr[0], 0, 1) * 255).astype(np.uint8)
        Image.fromarray(out).save(os.path.join(output_dir, file[:-4] + ".png"))
    print("Done!")


def match_images(args):
    files = [f for f in os.listdir(args.folder) if f.endswith(".mat")]
    comp_files = [f for f in os.listdir(args.comp_folder) if f.endswith(".mat")]
    os.makedirs(args.output_dir, exist_ok=True)
    for file in files:
        anchor = _load_mat_img(os.path.join(args.folder, file))
        for comp_file in comp_files:
            comp = _load_mat_img(os.path.join(args.comp_folder, comp_file))
            if anchor.shape == comp.shape and np.array_equal(anchor, comp):
                print(file, comp_file)
                src = os.path.join(args.rename_folder, comp_file[:-4] + ".png")
                dst = os.path.join(args.output_dir, file[:-4] + ".png")
                shutil.copy(src, dst)
                break


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", default="convert_mat")
    parser.add_argument("--folder", default="")
    parser.add_argument("--comp_folder", default="")
    parser.add_argument("--rename_folder", default="")
    parser.add_argument("--output_dir", default="")
    args = parser.parse_args()
    {"convert_mat": convert_mat,
     "match_images": match_images,
     "convert_coco_depth_map": convert_coco_depth_map}[args.task](args)

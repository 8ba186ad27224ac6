#!/usr/bin/env python
"""Convert Kinetics mp4s into per-video PNG frame trees, with the PyTorch
port (lvt_tpu_torch); the counterpart of scripts/convert_kinetics.py
(reference scripts/convert_kinetics.py).

For each <input_dir>/<class>/<video>.mp4: ffmpeg extracts the frames, each is
center-cropped to a square and LANCZOS-resized to --img_size, and written as
<output_dir>/<class>/<video>/<i>.png. Parallel over videos, one process each
(spawned).

--preprocess pil (the default) crops and resizes frame by frame with PIL on
the host, as the reference does. --preprocess device stacks a video's
frames and crops and resizes them on the card (--device, "cuda" unless
"cpu" is asked for), 64 frames at a time, with
lvt_tpu_torch/data/preprocess.py's center_crop_resize: within 1/255 of PIL at
the Kinetics downscale (>= 3.75x).

Usage:
  python scripts/convert_kinetics_torch.py --input_dir kinetics/train \
      --output_dir datasets/kinetics/train --img_size 64 --preprocess device
"""

import argparse
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from glob import glob
from shutil import rmtree

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
from PIL import Image

DEVICE_CHUNK = 64  # frames per device batch (bounds device and host memory)


def device_crop_resize(frames: np.ndarray, img_size: int, device="cuda") -> np.ndarray:
    """Center-crop and Lanczos-resize (N, H, W, 3) uint8 frames on ``device``,
    DEVICE_CHUNK frames at a time -> (N, img_size, img_size, 3) uint8."""
    import torch

    from lvt_tpu_torch.data.preprocess import center_crop_resize

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--preprocess device: no CUDA device (pass --device cpu to run it "
                         "on the CPU)")
    out = [center_crop_resize(torch.from_numpy(frames[i:i + DEVICE_CHUNK]).to(device),
                              img_size).cpu().numpy()
           for i in range(0, len(frames), DEVICE_CHUNK)]
    return np.concatenate(out, axis=0)


def process_video(path, output_dir, img_size, preprocess="pil", device="cuda"):
    """One video: extract, crop and resize its frames in place; returns the
    number of frames (0 where ffmpeg failed, logged to fail_convert.log)."""
    head, name = os.path.split(path)
    cls = os.path.basename(head)
    save_dir = os.path.join(output_dir, cls, name.split(".")[0])
    log_name = f"{cls}/{os.path.basename(save_dir)}"

    if os.path.exists(save_dir):
        rmtree(save_dir)
    os.makedirs(save_dir)

    cmd = f'ffmpeg -threads 1 -i "{path}" "{os.path.join(save_dir, "%d.png")}"'
    try:
        subprocess.check_output(cmd, shell=True, stderr=subprocess.STDOUT)
    except subprocess.CalledProcessError as e:
        print("Error while converting:", log_name, e.output[-200:])
        with open("fail_convert.log", "a") as f:
            f.write(path + "\n")
        return 0

    frames = glob(os.path.join(save_dir, "*.png"))
    if preprocess == "device":
        stack = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in frames], axis=0)
        for f, arr in zip(frames, device_crop_resize(stack, img_size, device)):
            Image.fromarray(arr).save(f)
    else:
        for frame in frames:
            img = Image.open(frame)
            width, height = img.size
            dim = min(width, height)
            left, top = (width - dim) / 2, (height - dim) / 2
            img = img.crop((left, top, left + dim, top + dim))
            img = img.resize((img_size, img_size), Image.LANCZOS)
            img.save(frame)
    print("Finished:", log_name, f"({len(frames)} frames)")
    return len(frames)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True,
                        help="directory of <class>/<video>.mp4 trees")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--img_size", type=int, default=64)
    parser.add_argument("--jobs", type=int, default=8)
    parser.add_argument("--preprocess", choices=["pil", "device"], default="pil",
                        help="'device': each video's frames cropped and Lanczos-resized at once "
                             "on --device instead of the per-frame host PIL loop; within 1/255 "
                             "of PIL at the Kinetics downscale")
    parser.add_argument("--device", default="cuda", help="the device of --preprocess device")
    args = parser.parse_args(argv)

    videos = sorted(glob(os.path.join(args.input_dir, "*", "*.mp4")))
    print(f"{len(videos)} videos")
    with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(process_video, v, args.output_dir, args.img_size,
                               args.preprocess, args.device)
                   for v in videos]
        total = sum(f.result() for f in futures)
    print(f"Done: {total} frames")
    return total


if __name__ == "__main__":
    main()

"""Image I/O and dataset-tree walkers (reference: vidgen/utils/image.py).

Pure numpy/PIL — no framework tensors. The walkers replicate the reference's
on-disk contract exactly: natural-sorted filenames, ``image_paths.npy`` /
``video_paths.npy`` caches inside the dataset root, `._`-prefixed AppleDouble
files skipped, and Kinetics class tagging from the parent directory name
(image.py:137-208).
"""

import os

import numpy as np
from PIL import Image, ImageOps

from .labels import KINETICS_LABEL_IDX
from .strings import natural_sorted

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG",
    ".png", ".PNG", ".ppm", ".PPM", ".bmp", ".BMP", ".tiff", ".webp",
)


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def read_image(file_name: str, format: str = None) -> np.ndarray:
    """Read an image as an HWC uint8 array, honoring EXIF orientation.

    format: a PIL mode ("RGB", "L") or "BGR" (reference image.py:211-246).
    """
    with open(file_name, "rb") as f:
        image = Image.open(f)
        try:
            image = ImageOps.exif_transpose(image)
        except Exception:
            pass
        if format is not None:
            conversion_format = "RGB" if format == "BGR" else format
            image = image.convert(conversion_format)
        image = np.asarray(image)
        if format == "BGR":
            image = image[:, :, ::-1]
        if format == "L":
            image = np.expand_dims(image, -1)
        return image


def save_image(image_numpy: np.ndarray, image_path: str, create_dir: bool = False) -> None:
    if create_dir:
        os.makedirs(os.path.dirname(image_path), exist_ok=True)
    if image_numpy.ndim == 2:
        image_numpy = np.expand_dims(image_numpy, axis=2)
    if image_numpy.shape[2] == 1:
        image_numpy = np.repeat(image_numpy, 3, 2)
    # rewrite only the EXTENSION to png (a str.replace would also rewrite a
    # '.jpg' occurring inside a directory component)
    root, ext = os.path.splitext(image_path)
    if ext == ".jpg":
        image_path = root + ".png"
    Image.fromarray(image_numpy).save(image_path)


def make_grid(imgs: np.ndarray, nrow: int = 8) -> np.ndarray:
    """Tile a (N, H, W, C) image stack into a grid."""
    if imgs.shape[0] % nrow != 0:
        pad = nrow - imgs.shape[0] % nrow
        imgs = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]), dtype=imgs.dtype)], axis=0)
    rows = [np.concatenate(list(imgs[i : i + nrow]), axis=1) for i in range(0, imgs.shape[0], nrow)]
    return np.concatenate(rows, axis=0)


def array2im(x, imtype=np.uint8, normalize=True, tile=False, nrow=8):
    """Convert a CHW (or NCHW) float array to an HWC uint8 image (reference
    ``tensor2im``, image.py:36-80). ``normalize`` treats input as [-1, 1]."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 4:
        images = np.stack([array2im(b, imtype, normalize) for b in x], axis=0)
        return make_grid(images, nrow) if tile else images
    if x.ndim == 2:
        x = x[None]
    x = np.transpose(x, (1, 2, 0))
    x = (x + 1) / 2.0 * 255.0 if normalize else x * 255.0
    x = np.clip(x, 0, 255)
    if x.shape[2] == 1:
        x = x[:, :, 0]
    return x.astype(imtype)


# keep the reference name as an alias
tensor2im = array2im


def get_image_paths(root, use_cache=True, is_kinetics=False):
    """Walk a dataset root for individual images -> list of dicts."""
    assert os.path.isdir(root) or os.path.islink(root), f"{root} is not a valid directory"
    cache_path = os.path.join(root, "image_paths.npy")
    if use_cache and os.path.exists(cache_path):
        return np.load(cache_path, allow_pickle=True).tolist()

    image_paths = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = natural_sorted(dirs)  # deterministic walk order
        for file in natural_sorted(files):
            if not is_image_file(file) or file.startswith("._"):
                continue
            d = {"image_path": os.path.join(dirpath, file)}
            if is_kinetics:
                d["class"] = KINETICS_LABEL_IDX[dirpath.split("/")[-2]]
            image_paths.append(d)

    if use_cache:
        try:
            np.save(cache_path, image_paths)
        except PermissionError:
            pass
    return image_paths


def get_video_paths(root, use_cache=True, is_kinetics=False):
    """Walk a dataset root for leaf dirs of frames -> list of video dicts
    with {"video_root", "image_names", "video_idx"[, "class"]}."""
    assert os.path.isdir(root) or os.path.islink(root), f"{root} is not a valid directory"
    cache_path = os.path.join(root, "video_paths.npy")
    if use_cache and os.path.exists(cache_path):
        return np.load(cache_path, allow_pickle=True).tolist()

    video_paths = []
    video_idx = 0
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = natural_sorted(dirs)  # deterministic walk order (video_idx must not depend on readdir order)
        if dirs:
            continue  # a video folder is a leaf containing only frames
        image_names = []
        is_video = True
        for file in natural_sorted(files):
            if not is_image_file(file):
                is_video = False
                break
            if not file.startswith("._"):
                image_names.append(file)
        if is_video and image_names:
            d = {"video_root": dirpath, "image_names": image_names, "video_idx": video_idx}
            if is_kinetics:
                d["class"] = KINETICS_LABEL_IDX[dirpath.split("/")[-2]]
            video_paths.append(d)
            video_idx += 1

    if use_cache:
        try:
            np.save(cache_path, video_paths)
        except PermissionError:
            pass
    return video_paths

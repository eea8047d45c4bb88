"""Recursive image-file walker (counterpart of ``ppst_tpu/data/image_folder.py``;
reference data/image_folder.py)."""

import os

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff", ".webp",
)


def is_image_file(fname: str) -> bool:
    return fname.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str, max_dataset_size=float("inf")):
    images = []
    directory = os.path.expanduser(directory)
    assert os.path.isdir(directory), f"{directory} is not a valid directory"
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images[: min(max_dataset_size, len(images))]

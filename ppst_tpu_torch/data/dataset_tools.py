"""Pack an image folder into one ``.pak`` file, or an LMDB directory where
the ``lmdb`` module imports (counterpart of ``ppst_tpu/data/dataset_tools.py``;
reference data/dataset_tools.py):

    python -m ppst_tpu_torch.data.dataset_tools --input DIR --output OUT.pak \\
        [--format pak|lmdb]

Every image under ``DIR`` (``make_dataset``'s walk, sorted) is converted to
RGB and stored as PNG under its path relative to ``DIR`` (``content/a.png``);
the file is byte for byte the JAX package's for the same folder.
"""

from __future__ import annotations

import argparse
import io
import os

from PIL import Image

from ppst_tpu_torch.data.image_folder import make_dataset
from ppst_tpu_torch.data.packed import write_pack


def encoded_images(input_dir: str):
    """(relative path, RGB PNG bytes) of every image under ``input_dir``."""
    paths = sorted(make_dataset(input_dir))
    print(f'Packing {len(paths)} images from "{input_dir}"')
    for idx, path in enumerate(paths):
        if idx % 50 == 0:
            print(f"{idx}\r", end="", flush=True)
        buf = io.BytesIO()
        Image.open(path).convert("RGB").save(buf, format="PNG")
        yield os.path.relpath(path, input_dir), buf.getvalue()


def images_to_pack(input_dir: str, output: str):
    write_pack(output, encoded_images(input_dir))


def images_to_lmdb(input_dir: str, output: str):
    import lmdb

    os.makedirs(output, exist_ok=True)
    env = lmdb.open(output, map_size=1 << 40)
    with env.begin(write=True) as txn:
        for key, data in encoded_images(input_dir):
            txn.put(key.encode(), data)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--format", choices=("pak", "lmdb"), default="pak")
    args = ap.parse_args(argv)
    (images_to_lmdb if args.format == "lmdb" else images_to_pack)(args.input, args.output)
    print(f'wrote "{args.output}"')


if __name__ == "__main__":
    main()

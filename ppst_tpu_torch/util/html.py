"""Minimal HTML image-gallery writer (a copy of ``ppst_tpu/util/html.py``;
reference util/html.py, which used the ``dominate`` package: the page is
simple enough to emit directly)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.refresh = refresh
        self.body: list = []

    def add_header(self, text: str):
        self.body.append(f"<h3>{text}</h3>")

    def add_images(self, ims, txts, links=None, width: int = 512):
        """ims: list of image paths (relative to web_dir) or uint8 HWC
        arrays (saved under images/)."""
        links = links or [None] * len(ims)
        cells = []
        for i, (im, txt, link) in enumerate(zip(ims, txts, links)):
            if isinstance(im, np.ndarray):
                from PIL import Image

                fname = f"images/{len(self.body)}_{i}_{txt.replace('/', '_')}.png"
                Image.fromarray(im).save(os.path.join(self.web_dir, fname))
                im = fname
            img_tag = f'<img src="{im}" style="width:{width}px">'
            if link:
                img_tag = f'<a href="{link}">{img_tag}</a>'
            cells.append(
                f'<td style="text-align:center;vertical-align:top">'
                f"{img_tag}<br><p>{txt}</p></td>"
            )
        self.body.append(
            '<table style="border-collapse:collapse"><tr>' + "".join(cells) + "</tr></table>"
        )

    def save(self, filename: Optional[str] = None):
        fname = filename or "index"
        refresh = (
            f'<meta http-equiv="refresh" content="{self.refresh}">'
            if self.refresh
            else ""
        )
        html = (
            f"<!DOCTYPE html><html><head><title>{self.title}</title>{refresh}"
            f"</head><body>{''.join(self.body)}</body></html>"
        )
        path = os.path.join(self.web_dir, f"{fname}.html")
        with open(path, "w") as f:
            f.write(html)
        return path

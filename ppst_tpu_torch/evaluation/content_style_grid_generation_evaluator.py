"""Content x style grid with guided-filter post-processing (counterpart of
``ppst_tpu/evaluation/content_style_grid_generation_evaluator.py``; reference
evaluation/content_style_grid_generation_evaluator.py).

A ``BaseEvaluator``: ``GroupEvaluator`` runs it on the loader of any
``--dataset_mode``, at train time and in ``python -m ppst_tpu_torch.test``.
Items with a ``content`` folder in their path are structure images; all
others are styles. The path may be relative, as a pack's keys are
(``content/a.png``, ``--dataset_mode lmdb``): the JAX package's evaluator
matches "/content/" only, and so takes every image of a pack for a style.
Every (content, style) pair is stylized in ``--dtype`` with the content as
the guided filter's guide, and the grid is written as an HTML page under
``output_dir()/<phase>_<nsteps>``, with the JAX package's page and file
names.

When all images share one shape, extraction runs once per image in batched
chunks (``PPSTModel.grid_extract``) and each content row of pairs is one
``grid_pairs`` dispatch. The row is converted to uint8 on the device and
copied to the host asynchronously; its PNGs are encoded on a thread pool
while the next row runs on the device. Otherwise each pair runs the
per-pair pipeline. ``self.page`` is the last page written.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ppst_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from ppst_tpu_torch.models.ppst import cat_banks, take_rows
from ppst_tpu_torch.ops.corr import rselfcorr
from ppst_tpu_torch.util.html import HTML
from ppst_tpu_torch.util.util import save_image, tensor2im


def _to_host_async(t):
    """Start copying ``t`` to the host; returns the host tensor and an event
    to wait on (None on the CPU, where the copy is the tensor itself)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class ContentStyleGridGenerationEvaluator(BaseEvaluator):
    def create_webpage(self, nsteps):
        nsteps = self.opt.resume_iter if nsteps is None else nsteps
        savedir = os.path.join(self.output_dir(), f"{self.target_phase}_{nsteps}")
        os.makedirs(savedir, exist_ok=True)
        self.webpage = HTML(savedir, f"{self.opt.name}. iter={nsteps}. "
                                     f"phase={self.target_phase}")

    def add_to_webpage(self, images, filenames):
        self.webpage.add_images([tensor2im(im)[0] for im in images], filenames)
        print(f"saved {filenames}")

    @torch.no_grad()
    def evaluate(self, model, dataset, nsteps=None, generator=None):
        """``dataset``: an iterable of batches ``{real_A, path_A}``. Writes the
        page and its PNGs (the page's path in ``self.page``)."""
        dtype = getattr(torch, getattr(self.opt, "dtype", "float32"))
        self.create_webpage(nsteps)
        structure_images, style_images = {}, {}
        for data_i in dataset:
            for j in range(data_i["real_A"].shape[0]):
                image = np.asarray(data_i["real_A"][j : j + 1])
                path = data_i["path_A"][j]
                name = os.path.splitext(os.path.basename(path))[0]
                if "/content/" in "/" + path:
                    structure_images[name] = image
                else:
                    style_images[name] = image
        style_paths, structure_paths = list(style_images), list(structure_images)

        blank = style_images[style_paths[0]] * 0.0 + 1.0
        self.add_to_webpage([blank] + [style_images[p] for p in style_paths],
                            ["blank.png"] + [p + ".png" for p in style_paths])
        shapes = {im.shape for im in (*structure_images.values(), *style_images.values())}
        run = self._evaluate_batched if len(shapes) == 1 else self._evaluate_pairwise
        run(model, structure_images, style_images, structure_paths, style_paths,
            generator, dtype)
        self.page = self.webpage.save()
        return {}

    def _evaluate_batched(self, model, structure_images, style_images, structure_paths,
                          style_paths, generator, dtype):
        """One batched extraction over all images, in chunks of about sixteen
        512px-equivalent images (at least 4), then one pair dispatch per
        content row."""
        n_c, n_s = len(structure_paths), len(style_paths)
        contents = np.concatenate([structure_images[n] for n in structure_paths])
        styles = np.concatenate([style_images[n] for n in style_paths])
        all_imgs = torch.from_numpy(np.concatenate([contents, styles])).to(model.device, dtype)
        crop = all_imgs.shape[1]
        chunk = max(4, (16 * 512 * 512) // (crop * crop))
        bank = cat_banks([model.grid_extract(all_imgs[o : o + chunk], generator)
                           for o in range(0, all_imgs.shape[0], chunk)])
        c_bank = {k: take_rows(v, slice(None, n_c)) for k, v in bank.items()}
        s_bank = {k: take_rows(v, slice(n_c, None)) for k, v in bank.items()}
        contents_dev = all_imgs[:n_c]

        pool = ThreadPoolExecutor(max_workers=8)
        encodes = []

        def flush(host, done, c_name):
            if done is not None:
                done.synchronize()
            arr = host.numpy()
            names = [c_name + ".png"] + [f"{c_name}_{s}.png" for s in style_paths]
            imgs = [tensor2im(structure_images[c_name])[0]] + [arr[k] for k in range(n_s)]
            files = []
            for i, (im, txt) in enumerate(zip(imgs, names)):
                fname = f"images/{len(self.webpage.body)}_{i}_{txt}"
                encodes.append(pool.submit(save_image, im,
                                           os.path.join(self.webpage.web_dir, fname)))
                files.append(fname)
            self.webpage.add_images(files, names)
            print(f"saved {names}")

        si = torch.arange(n_s, device=model.device)
        pending = None
        for j, c_name in enumerate(structure_paths):
            ci = torch.full((n_s,), j, dtype=torch.long, device=model.device)
            outs = model.grid_pairs(c_bank, s_bank, ci, si, generator,
                                    smooth_target=contents_dev)
            row = _to_host_async(model.to_uint8(outs))
            if pending is not None:
                flush(*pending)  # while this row runs on the device
            pending = (*row, c_name)
        if pending is not None:
            flush(*pending)
        for f in encodes:
            f.result()
        pool.shutdown()

    def _evaluate_pairwise(self, model, structure_images, style_images, structure_paths,
                           style_paths, generator, dtype):
        """The per-pair pipeline, for images of mixed shapes."""
        dev = model.device

        def load(image):
            return torch.from_numpy(image).to(dev, dtype)

        def desc(image):
            fea, fea1 = model.extract_feat_from_image(image, generator)
            return torch.cat([fea, rselfcorr(fea1)], dim=-1)

        style_descs = {n: desc(load(style_images[n])) for n in style_paths}
        for c_name in structure_paths:
            structure_image = load(structure_images[c_name])
            sp, _ = model.encode(structure_image)
            desc_c = desc(structure_image)
            swaps, filenames = [], []
            for s_name in style_paths:
                corr = model.corrm(style_descs[s_name], desc_c)
                _, gl_w = model.encode2(load(style_images[s_name]), corr,
                                        corr_out_hw=(desc_c.shape[1], desc_c.shape[2]))
                swaps.append(model.decode(sp, gl_w, generator, target=structure_image))
                filenames.append(f"{c_name}_{s_name}.png")
            self.add_to_webpage([structure_image] + swaps, [c_name + ".png"] + filenames)
            self.webpage.save()

"""The (N+1) x (N+1) swap-visualization grid of training (counterpart of
``ppst_tpu/evaluation/swap_visualization_evaluator.py``; reference
evaluation/swap_visualization_evaluator.py): N images from the loader in
the evaluator's phase along the top row and the left column, and in cell
(i, j) image i's structure with image j's style warped to it. Cells are
``load_size`` wide, images centred in them; the grids go to an HTML page.
The model runs in the training dtype (``--dtype``), without grad."""

from __future__ import annotations

import os

import numpy as np
import torch

from ppst_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from ppst_tpu_torch.ops.corr import rselfcorr
from ppst_tpu_torch.util.html import HTML
from ppst_tpu_torch.util.util import tensor2im

class SwapVisualizationEvaluator(BaseEvaluator):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--swap_num_columns", type=int, default=4,
                            help="images per swap grid (grid is NxN plus a row/col of originals)")
        parser.add_argument("--swap_num_images", type=int, default=16,
                            help="total images to swap across all grids")
        return parser

    def gather_images(self, dataset):
        """Up to ``swap_num_columns`` (1, H, W, 3) images from the loader, and
        whether it ran out."""
        images = []
        want = self.opt.swap_num_columns
        exhausted = False
        while len(images) < want:
            try:
                data = next(dataset)
            except StopIteration:
                exhausted = True
                break
            for i in range(data["real_A"].shape[0]):
                images.append(np.asarray(data["real_A"][i : i + 1]))
                if len(images) >= want:
                    break
        if not images:
            return None, True
        return images, exhausted

    @torch.no_grad()
    def generate_mix_grid(self, model, images, generator=None):
        """The uint8 grid of ``images`` (a list of (1, H, W, 3) float arrays)."""
        n = len(images)
        dtype = getattr(torch, getattr(self.opt, "dtype", "float32"))
        xs = [torch.from_numpy(im).to(model.device, dtype) for im in images]
        sps, descs = [], []
        for x in xs:
            sp, _ = model.encode(x)
            fea, fea1 = model.extract_feat_from_image(x, generator)
            descs.append(torch.cat([fea, rselfcorr(fea1)], dim=-1))
            sps.append(sp)

        cell = self.opt.load_size
        grid = np.ones((cell * (n + 1), cell * (n + 1), 3), np.uint8)

        def put(img, row, col):
            h, w = img.shape[:2]
            y = cell * row + (cell - h) // 2
            x = cell * col + (cell - w) // 2
            grid[y : y + h, x : x + w] = img

        for i, image in enumerate(images):
            img_np = tensor2im(image)[0]
            put(img_np, 0, i + 1)
            put(img_np, i + 1, 0)

        all_styles = torch.cat(descs, dim=0)
        all_images = torch.cat(xs, dim=0)
        for i in range(n):
            corr = model.corrm(all_styles, descs[i].repeat(n, 1, 1, 1))
            _, gl_w = model.encode2(all_images, corr)
            mix_row = model.decode(sps[i].repeat(n, 1, 1, 1), gl_w, generator)
            for j, mix in enumerate(tensor2im(mix_row)):
                put(mix, i + 1, j + 1)
        return grid

    def evaluate(self, model, dataset, nsteps=None, generator=None):
        # test.py passes --resume_iter itself (the JAX package's evaluator
        # divides that string by 1000 and raises)
        if nsteps is None:
            nsteps = getattr(self.opt, "resume_iter", "latest")
        elif not isinstance(nsteps, str):
            nsteps = f"{round(nsteps / 1000)}k"
        savedir = os.path.join(self.output_dir(), f"{self.target_phase}_{nsteps}")
        os.makedirs(savedir, exist_ok=True)
        webpage = HTML(savedir, f"Swap Visualization of {self.opt.name}. "
                                f"iter={nsteps}. phase={self.target_phase}")
        num_repeats = -(-self.opt.swap_num_images // self.opt.swap_num_columns)
        for i in range(num_repeats):
            images, exhausted = self.gather_images(dataset)
            if images is None:
                break
            webpage.add_images([self.generate_mix_grid(model, images, generator)],
                               ["%04d.png" % i])
            if exhausted:
                break
        webpage.save()
        return {}

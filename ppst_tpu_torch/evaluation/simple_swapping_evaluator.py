"""One content + one style image -> stylized output(s) (counterpart of
``ppst_tpu/evaluation/simple_swapping_evaluator.py``; reference
evaluation/simple_swapping_evaluator.py, the README's inference path).

A ``BaseEvaluator``: ``GroupEvaluator`` runs it with the loader, which it
does not read. Its flags make ``--dataroot`` default to the content
image's folder and ``--dataset_mode`` to ``imagefolder``, as the JAX
package's do. The model runs in ``--dtype``; ``self.paths`` lists the PNGs
of the last ``evaluate``."""

from __future__ import annotations

import os

import torch
from PIL import Image

from ppst_tpu_torch.data.base_dataset import get_transform
from ppst_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from ppst_tpu_torch.ops.corr import rselfcorr
from ppst_tpu_torch.util.util import lerp, save_image, tensor2im


class SimpleSwappingEvaluator(BaseEvaluator):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--input_structure_image", required=True, type=str)
        parser.add_argument("--input_texture_image", required=True, type=str)
        parser.add_argument("--texture_mix_alphas", type=float, nargs="+", default=[1.0],
                            help="Interpolation weight(s) of the texture image: 1.0 = full "
                                 "swap, 0.0 = direct reconstruction")
        opt, _ = parser.parse_known_args()
        parser.set_defaults(dataroot=os.path.dirname(opt.input_structure_image),
                            dataset_mode="imagefolder")
        return parser

    def load_image(self, path, device, dtype):
        img = Image.open(os.path.expanduser(path)).convert("RGB")
        return torch.from_numpy(get_transform(self.opt)(img)[None]).to(device, dtype)

    @torch.no_grad()
    def evaluate(self, model, dataset=None, nsteps=None, generator=None):
        """Writes one PNG per texture mix alpha (their paths in ``self.paths``)."""
        opt = self.opt
        dtype = getattr(torch, getattr(opt, "dtype", "float32"))
        structure_image = self.load_image(opt.input_structure_image, model.device, dtype)
        texture_image = self.load_image(opt.input_texture_image, model.device, dtype)
        os.makedirs(self.output_dir(), exist_ok=True)

        structure_code, source_texture_code = model.encode(structure_image)
        fea_c, fea_c1 = model.extract_feat_from_image(structure_image, generator)
        fea_s, fea_s1 = model.extract_feat_from_image(texture_image, generator)
        desc_c = torch.cat([fea_c, rselfcorr(fea_c1)], dim=-1)
        desc_s = torch.cat([fea_s, rselfcorr(fea_s1)], dim=-1)
        corrmatrix = model.corrm(desc_s, desc_c)
        content_grid = (desc_c.shape[1], desc_c.shape[2])
        _, gl_w = model.encode2(texture_image, corrmatrix, corr_out_hw=content_grid)

        self.paths = []
        for alpha in opt.texture_mix_alphas:
            texture_code = lerp(list(source_texture_code), list(gl_w), alpha)
            output_image = model.decode(structure_code, texture_code, generator)
            output_name = "%s_%s_%.2f.png" % (
                os.path.splitext(os.path.basename(opt.input_structure_image))[0],
                os.path.splitext(os.path.basename(opt.input_texture_image))[0],
                alpha,
            )
            output_path = os.path.join(self.output_dir(), output_name)
            save_image(tensor2im(output_image)[0], output_path)
            print("Saved at " + output_path)
            self.paths.append(output_path)
        return {}

"""One content + one style image -> stylized output(s) (counterpart of
``ppst_tpu/evaluation/simple_swapping_evaluator.py``; reference
evaluation/simple_swapping_evaluator.py, the README's inference path)."""

from __future__ import annotations

import os

import torch
from PIL import Image

from ppst_tpu_torch.data.base_dataset import get_transform
from ppst_tpu_torch.ops.corr import rselfcorr
from ppst_tpu_torch.util.util import lerp, save_image, tensor2im


class SimpleSwappingEvaluator:
    def __init__(self, opt):
        self.opt = opt

    def output_dir(self):
        return os.path.join(self.opt.result_dir, self.opt.name, self.opt.dataname,
                            "simpleswapping")

    def load_image(self, path, device, dtype):
        img = Image.open(os.path.expanduser(path)).convert("RGB")
        return torch.from_numpy(get_transform(self.opt)(img)[None]).to(device, dtype)

    @torch.inference_mode()
    def evaluate(self, model, generator=None, dtype=torch.float32):
        """Writes one PNG per texture mix alpha and returns their paths."""
        opt = self.opt
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

        paths = []
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
            paths.append(output_path)
        return paths

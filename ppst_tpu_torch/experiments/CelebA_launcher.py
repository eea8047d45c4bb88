"""The CelebAMask-HQ experiment (counterpart of
``ppst_tpu/experiments/CelebA_launcher.py``; reference
experiments/CelebA_launcher.py: 512px, batch 2, ``--preprocess resize``).
Train: the canonical run, resumed where it has a checkpoint, with the
swap_visualization evaluator every 50000 images. Test: the content x style
grid (``content_style_1t1_generation``) over a CelebAMask tree at
``scale_width``; ``--dataroot`` is a placeholder to replace."""

from ppst_tpu_torch.experiments.tmux_launcher import Options, TmuxLauncher


class Launcher(TmuxLauncher):
    def options(self):
        opt = Options()
        opt.set(
            dataroot="~/datasets/CelebAMaskHQ/img/",
            dataroot2="~/datasets/CelebAMaskHQ/label/",
            dataset_mode="CelebAMask",
            checkpoints_dir="./checkpoints/",
            num_gpus=1,
            batch_size=2,
            preprocess="resize",
            load_size=512,
            crop_size=512,
        )
        return [
            opt.specify(
                name="CelebAMaskHQ_default",
                model="ppst",
                optimizer="ppst",
            ),
        ]

    def train_options(self):
        return [
            opt.specify(
                continue_train=True,
                evaluation_metrics="swap_visualization",
                evaluation_freq=50000,
            )
            for opt in self.options()
        ]

    def test_options(self):
        opts = self.options()[0]
        return [
            opts.tag("swapping_grid").specify(
                num_gpus=1,
                batch_size=1,
                dataroot="your test data",
                dataname="test1",
                dataset_mode="CelebAMask",
                preprocess="scale_width",
                evaluation_metrics="content_style_1t1_generation",
            ),
        ]

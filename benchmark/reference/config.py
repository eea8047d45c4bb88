"""Architecture configuration shared by all PPST networks.

A copy of ``ppst_tpu.models.config.PPSTConfig``: the same fields, the same
defaults, so one configuration describes both packages. Field names mirror
the reference CLI flags. ``remat``/``remat_nets`` select the training
passes that ``torch.utils.checkpoint`` recomputes; ``remat_taps`` and
``remat_blocks`` recompute G's feature taps and resblocks one at a time,
``unbatch_passes`` splits the D step's passes, ``corr_blockwise`` trains
through the blockwise correspondence (the 1024px training mode), and
``remat_save_kernels`` keeps the prepared conv and linear kernels across
the checkpointed passes instead of preparing them again in the recompute.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PPSTConfig:
    # core dims (reference models/ppst_model.py:19-20)
    spatial_code_ch: int = 256
    global_code_ch: int = 2048
    num_classes: int = 0
    crop_size: int = 512
    use_antialias: bool = True

    # E1 (reference encoder_con.py:14-19)
    netE_scale_capacity: float = 1.0
    netE_num_downsampling_sp: int = 3
    netE_nc_steepness: float = 2.0

    # E2 (reference encoder_col.py:15-20)
    netE2_scale_capacity: float = 1.0
    netE2_num_downsampling_gl1: int = 3
    netE2_nc_steepness: float = 2.0

    # G (reference generator.py:127-138)
    netG_scale_capacity: float = 1.0
    netG_num_base_resnet_layers: int = 4
    netG_use_noise: bool = True
    netG_resnet_ch: int = 256

    # D (reference discriminator.py:7-9)
    netD_scale_capacity: float = 1.0

    # network selection (reference options/__init__.py:46-49)
    netG: str = "StyleGAN2Resnet"
    netD: str = "StyleGAN2"
    netE1: str = "StyleGAN2Resnet"
    netE2: str = "StyleGAN2Resnet"

    # losses (reference ppst_model.py:21-34)
    lambda_R1: float = 10.0
    lambda_L1: float = 3.0
    lambda_GAN: float = 1.0
    training_stage: int = 2
    lambda_StyleCon: float = 1.0
    lambda_Maskwarp: float = 10.0
    lambda_Cycwarp: float = 5.0
    match_kernel: int = 1
    nce_T: float = 0.07

    # optimizer (reference ppst_optimizer.py:13-22)
    lr: float = 0.001
    beta1: float = 0.0
    beta2: float = 0.99
    R1_once_every: int = 16

    # compute dtype for the conv stack ("float32" | "bfloat16"); params
    # always stay float32.
    dtype: str = "float32"

    # training passes recomputed in the backward (torch.utils.checkpoint):
    # "all", or a comma list of call-site prefixes ("g" = every G pass)
    remat: bool = True
    remat_nets: str = "g"
    # keep the prepared kernels (equalized-lr scale, folded blur, upscaling
    # kernel) across the checkpointed passes (models.ppst.save_kernels_policy);
    # bit-exact either way
    remat_save_kernels: bool = False
    # recompute each feature tap / fuse block, each G resblock
    remat_taps: bool = False
    remat_blocks: bool = False
    # D step: separate G passes for mix and rec, one D pass per part
    unbatch_passes: bool = False
    # training correspondences as (q, k) descriptors through
    # ops.corr_blockwise.corr_warp_scan, in row blocks of corr_block
    corr_blockwise: bool = False
    corr_block: int = 512

    # serving approximation: pool E2's warp grid directly instead of
    # bilinear-upsampling it first. Off by default for reference parity.
    e2_fast_warp_pool: bool = False
    # route the generator's 1x1 feature tap through the fused tap kernel
    # (ops.tap_cuda) when the compute dtype is bfloat16
    fused_tap: bool = False
    # route the generator's non-upsampled 3x3 StyledConvs through the fused
    # StyledConv kernel (ops.styled_conv_cuda) when the compute dtype is bfloat16
    fused_styled_conv: bool = False

    @classmethod
    def from_options(cls, opt) -> "PPSTConfig":
        """The configuration from parsed CLI options: every field the
        options name, the defaults for the rest."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(opt).items() if k in names})

    @property
    def style_dim(self) -> int:
        return self.global_code_ch + self.num_classes

    def nc_e1(self, idx: int) -> int:
        nc = self.netE_nc_steepness ** (5 + idx) * self.netE_scale_capacity
        return round(min(self.global_code_ch, int(round(nc))))

    def nc_e2(self, idx: int) -> int:
        nc = self.netE2_nc_steepness ** (5 + idx) * self.netE2_scale_capacity
        return round(min(self.global_code_ch, int(round(nc))))

    def nf_g(self, num_up: int) -> int:
        ch = 128 * (2 ** (self.netE_num_downsampling_sp - num_up))
        return int(min(512, ch) * self.netG_scale_capacity)

    @property
    def g_fuse_ch(self) -> int:
        """Channel width of the generator feature branch's fused output
        (concat of the n_up+1 taps) and of the mean-centered head of the
        correspondence descriptor."""
        return (self.netE_num_downsampling_sp + 1) * (self.netG_resnet_ch // 4)

    @property
    def e_blur_kernel(self):
        return (1, 2, 1) if self.use_antialias else (1,)

    @property
    def gd_blur_kernel(self):
        return (1, 3, 3, 1) if self.use_antialias else (1,)

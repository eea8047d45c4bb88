"""Model- and network-level CLI flags (counterpart of
``ppst_tpu/options/flags.py``): the same names, types and defaults, so the
JAX package's command lines run unchanged. ``--lambda_triplet``,
``--lambda_hist``, ``--num_patches``,
``--nce_includes_all_negatives_from_minibatch``, ``--netE_num_downsampling_gl``
and ``--netE2_num_downsampling_gl2`` are accepted and recorded in ``opt.txt``;
nothing reads them, as in the JAX package."""

from ppst_tpu_torch.util.util import str2bool


def add_model_flags(parser, is_train=True):
    parser.add_argument("--spatial_code_ch", default=256, type=int)
    parser.add_argument("--global_code_ch", default=2048, type=int)
    parser.add_argument("--lambda_R1", default=10.0, type=float)
    parser.add_argument("--lambda_L1", default=3.0, type=float)
    parser.add_argument("--lambda_GAN", default=1.0, type=float)
    parser.add_argument("--training_stage", default=2, type=int)
    parser.add_argument("--lambda_StyleCon", default=1.0, type=float)
    parser.add_argument("--lambda_Maskwarp", default=10.0, type=float)
    parser.add_argument("--lambda_Cycwarp", default=5.0, type=float)
    parser.add_argument("--match_kernel", default=1, type=int)
    parser.add_argument("--lambda_triplet", default=0.0, type=float)
    parser.add_argument("--lambda_hist", default=0.0, type=float)
    parser.add_argument("--num_patches", type=int, default=128,
                        help="number of patches per layer")
    parser.add_argument("--nce_includes_all_negatives_from_minibatch",
                        type=str2bool, nargs="?", const=True, default=True)
    parser.add_argument("--nce_T", type=float, default=0.07, help="temperature for NCE loss")
    return parser


def add_network_flags(parser, is_train=True):
    # E1
    parser.add_argument("--netE_scale_capacity", default=1.0, type=float)
    parser.add_argument("--netE_num_downsampling_sp", default=3, type=int)
    parser.add_argument("--netE_num_downsampling_gl", default=2, type=int)
    parser.add_argument("--netE_nc_steepness", default=2.0, type=float)
    # E2
    parser.add_argument("--netE2_scale_capacity", default=1.0, type=float)
    parser.add_argument("--netE2_num_downsampling_gl1", default=3, type=int)
    parser.add_argument("--netE2_num_downsampling_gl2", default=0, type=int)
    parser.add_argument("--netE2_nc_steepness", default=2.0, type=float)
    # G
    parser.add_argument("--netG_scale_capacity", default=1.0, type=float)
    parser.add_argument("--netG_num_base_resnet_layers", default=4, type=int,
                        help="resnet layers before the upsampling layers")
    parser.add_argument("--netG_use_noise", type=str2bool, nargs="?", const=True,
                        default=True)
    parser.add_argument("--netG_resnet_ch", type=int, default=256)
    # D
    parser.add_argument("--netD_scale_capacity", default=1.0, type=float)
    return parser

"""NHWC ops of the port: FIR resampling, bias/activation, resampling conv,
modulated conv, SPADE's normalisation, and the hand-written K1 conv
kernel."""

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .conv3x3 import conv3x3_valid, conv3x3_valid_plain
from .filters import setup_filter
from .modulated_conv import modulated_conv2d
from .spade_norm import spade_norm_act, spade_norm_stats
from .upfirdn2d import downsample2d, filter2d, upfirdn2d, upsample2d

__all__ = [
    "activation_funcs", "bias_act", "conv2d_resample", "conv3x3_valid", "conv3x3_valid_plain", "setup_filter",
    "modulated_conv2d", "spade_norm_act", "spade_norm_stats", "downsample2d",
    "filter2d", "upfirdn2d", "upsample2d",
]

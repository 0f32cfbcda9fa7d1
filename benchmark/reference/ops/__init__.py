"""NHWC ops of the reference."""

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .conv3x3 import conv3x3_valid, conv3x3_valid_plain
from .filters import setup_filter
from .modulated_conv import modulated_conv2d
from .upfirdn2d import downsample2d, filter2d, upfirdn2d, upsample2d

"""Quality metrics: FID / KID / IS / precision-recall / PPL, port of
pasta_tpu/metrics/.

The formulas over features (`feature_stats`, `fid`, `kid`,
`inception_score`) are copies of the JAX package's numpy code; the
detectors (`inception.InceptionV3`, `vgg16.VGG16` with LPIPS), the k-NN
precision / recall and the try-on PPL run in PyTorch on the card unless
the caller asks for the CPU. `metric_main` is the registry and the runner
that `cli/calc_metrics.py` and the training loop's evaluator use.
"""

from .feature_stats import FeatureStats
from .fid import compute_fid
from .inception_score import compute_is
from .kid import compute_kid
from .precision_recall import compute_pr

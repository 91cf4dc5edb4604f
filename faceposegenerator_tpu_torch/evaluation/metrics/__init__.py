"""The dgm-eval metrics (port of `faceposegenerator_tpu/evaluation/metrics/`)."""

from .fd import frechet_distance, frechet_distance_inf
from .mmd import mmd2_polynomial, kernel_distance
from .prdc import prdc
from .vendi import vendi_score, per_class_vendi
from .authpct import authpct
from .inception_score import inception_score_from_logits
from .sw import sliced_wasserstein
from .ct import ct_score
from .fls import fls

"""The GP models ported so far (port of ``cggp_tpu/models``): the dense
``GPR`` and the matrix-free exact ``IterGPR``, the Cholesky ``ClusterGP``
oracle, the dense ``CGGP`` and the matrix-free ``ImplicitCGGP``, with their
serving caches."""

from cggp_tpu_torch.models.base import CholPosterior, GaussianLikelihood
from cggp_tpu_torch.models.gpr import GPR, GPRPosterior
from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.models.cggp import CGGP, CGGPPosterior
from cggp_tpu_torch.models.implicit import ImplicitCGGP, ImplicitCGGPPosterior
from cggp_tpu_torch.models.itergpr import IterGPR, IterGPRPosterior

__all__ = [
    "GaussianLikelihood",
    "GPR",
    "ClusterGP",
    "CGGP",
    "ImplicitCGGP",
    "IterGPR",
    "CholPosterior",
    "GPRPosterior",
    "CGGPPosterior",
    "ImplicitCGGPPosterior",
    "IterGPRPosterior",
]

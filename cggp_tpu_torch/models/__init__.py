"""The GP models (port of ``cggp_tpu/models``): the dense ``GPR`` and the
matrix-free exact ``IterGPR``, the Cholesky ``ClusterGP`` oracle, the dense
``CGGP`` and the matrix-free ``ImplicitCGGP``, the baselines ``SGPR`` and
``LpSVGP``, and ``PathwiseClusterGP`` with the pathwise serving cache, each
with its serving cache."""

from cggp_tpu_torch.models.base import CholPosterior, GaussianLikelihood
from cggp_tpu_torch.models.gpr import GPR, GPRPosterior
from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.models.cggp import CGGP, CGGPPosterior
from cggp_tpu_torch.models.implicit import ImplicitCGGP, ImplicitCGGPPosterior
from cggp_tpu_torch.models.itergpr import IterGPR, IterGPRPosterior
from cggp_tpu_torch.models.lpsvgp import LpSVGP
from cggp_tpu_torch.models.pathwise import (PathwiseClusterGP, PathwisePosterior,
                                            build_pathwise_posterior, pathwise_samples_at,
                                            pathwise_samples_scan)
from cggp_tpu_torch.models.sgpr import SGPR, SGPRPosterior

__all__ = [
    "GaussianLikelihood",
    "SGPR",
    "GPR",
    "LpSVGP",
    "ClusterGP",
    "PathwiseClusterGP",
    "CGGP",
    "ImplicitCGGP",
    "IterGPR",
    "CholPosterior",
    "GPRPosterior",
    "SGPRPosterior",
    "CGGPPosterior",
    "ImplicitCGGPPosterior",
    "IterGPRPosterior",
    "PathwisePosterior",
    "build_pathwise_posterior",
    "pathwise_samples_at",
    "pathwise_samples_scan",
]

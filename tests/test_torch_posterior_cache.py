"""The port's serving caches and ``posterior`` signatures against the JAX
package's: the same NamedTuple fields in the same order, and the same
parameter names, so that a cache reads the same in both packages."""

import inspect

import numpy as np
import pytest
import torch

from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.models.cggp import CGGPPosterior as JaxCGGPPosterior
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.models.rowcg import RowCGGPPosterior as JaxRowCGGPPosterior
from cggp_tpu.models.rowcg import RowSolveCGGP as JaxRowSolveCGGP
from cggp_tpu_torch.models.cggp import CGGP, CGGPPosterior
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.models.rowcg import RowCGGPPosterior, RowSolveCGGP
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32

torch.set_num_threads(1)


@pytest.mark.parametrize("port, jax_cls", [(CGGPPosterior, JaxCGGPPosterior),
                                           (RowCGGPPosterior, JaxRowCGGPPosterior)],
                         ids=["CGGPPosterior", "RowCGGPPosterior"])
def test_posterior_cache_fields_match_jax(port, jax_cls):
    assert port._fields == jax_cls._fields
    assert port._field_defaults.keys() == jax_cls._field_defaults.keys()


@pytest.mark.parametrize("port, jax_cls", [(CGGP, JaxCGGP), (RowSolveCGGP, JaxRowSolveCGGP),
                                           (ImplicitCGGP, JaxImplicitCGGP)],
                         ids=["CGGP", "RowSolveCGGP", "ImplicitCGGP"])
def test_posterior_parameters_match_jax(port, jax_cls):
    names = list(inspect.signature(port.posterior).parameters)
    assert names == list(inspect.signature(jax_cls.posterior).parameters)
    defaults = {k: p.default for k, p in inspect.signature(port.posterior).parameters.items()
                if p.default is not inspect.Parameter.empty}
    jax_defaults = {k: p.default
                    for k, p in inspect.signature(jax_cls.posterior).parameters.items()
                    if p.default is not inspect.Parameter.empty}
    assert defaults == jax_defaults


@pytest.mark.parametrize("solver", ["cg", "chol"])
def test_cggp_posterior_fills_the_jax_fields(solver):
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, (12, 2))
    model = CGGP(kernel=Matern32(), num_data=100,
                 conjugate_gradient=ConjugateGradient(1e-12, matvec_impl="xla"))
    params = model.init_params(z, pseudo_u=rng.standard_normal((12, 1)),
                               cluster_counts=rng.integers(1, 9, (12, 1)).astype(float),
                               dtype=torch.float64, device="cpu")
    post = model.posterior(params, None, solver)
    assert post.precond_state == ()
    assert post.lanczos_r is None and post.inducing_mask is None
    torch.testing.assert_close(post.lam, model.diag_variance(params)[:, 0], rtol=0, atol=0)
    assert (post.chol is None) == (solver == "cg")
    assert (post.kmm_lambda is None) == (solver == "chol")

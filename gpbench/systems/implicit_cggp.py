"""The system under test for configurations with ``"system":
"implicit_cggp"``: the program's matrix-free ``ImplicitCGGP``, its inducing
set padded to a multiple of the panel height behind a mask."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from gpbench.systems.cggp import System as DenseSystem


class System(DenseSystem):
    def __init__(self, cfg: Dict, inputs, device: torch.device):
        from cggp_tpu_torch.models.implicit import ImplicitCGGP
        from cggp_tpu_torch.ops.kernels import kernel_by_name

        self.attach(cfg, inputs)
        model_cfg = cfg["model"]
        self.num_probes = int(model_cfg["num_probes"])
        self.model = ImplicitCGGP(
            kernel=kernel_by_name(model_cfg["kernel"]), num_data=int(inputs.x.shape[0]),
            block=int(model_cfg["block"]), use_pallas=bool(model_cfg["use_pallas"]),
            precondition=model_cfg["precondition"], precond_rank=int(model_cfg["precond_rank"]),
            relative_threshold=bool(model_cfg["relative_threshold"]),
            error_threshold=float(model_cfg["error_threshold"]),
            max_cg_iterations=int(model_cfg["max_cg_iterations"]),
            num_probes=self.num_probes, logdet_variant=model_cfg["logdet_variant"])
        self.params = self.model.init_params(
            inputs.z, pseudo_u=inputs.u, cluster_counts=inputs.counts,
            variance=float(inputs.kernel_variance), lengthscales=inputs.lengthscales,
            noise_variance=float(inputs.noise_variance), dtype=torch.float32, device=device)
        self.m_real = inputs.m
        self.m_pad = int(self.params["inducing_points"].shape[0])

    def reference_probes(self, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step's (trace, logdet) probes as the program draws them:
        [P, M_pad] each, trace first, the pads (the last columns) masked;
        returned as the real columns in the [M_real, P] layout."""
        shape = (self.num_probes, self.m_pad)
        return tuple((2.0 * torch.randint(0, 2, shape, generator=gen, device=gen.device)
                      - 1.0)[:, :self.m_real].T for _ in range(2))

    @contextlib.contextmanager
    def recording_solves(self):
        """Every matrix-free solve's ``(rows, m_real, steps tensor)``."""
        from cggp_tpu_torch.ops import cg_implicit

        solves: List = []
        impl = cg_implicit._implicit_cg_impl

        def recording(matvec, precond_state, rhs, *args):
            solution, stats = impl(matvec, precond_state, rhs, *args)
            solves.append((int(rhs.shape[-2]), self.m_real, stats.steps))
            return solution, stats

        cg_implicit._implicit_cg_impl = recording
        try:
            yield solves
        finally:
            cg_implicit._implicit_cg_impl = impl

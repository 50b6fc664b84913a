"""The system under test for configurations with ``"system": "cggp"``: the
program's dense ``CGGP``.

A system object builds the program's model and parameters from a
configuration and the benchmark's inputs, names the trainable leaves, and
runs the configuration's reference (its ``"reference"`` file) on the same
inputs: the reference draws the program's probes from a generator of the
same seed.  It also wraps the program's CG entry for the traced run, to
read each solve's rows and steps.  The traffic kinds reach the model and
its reference only through these methods.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from gpbench import harness


class System:
    # The program's trainable leaves, by their reference names.
    LEAVES = {"kernel_variance": ("kernel", "variance"),
              "lengthscales": ("kernel", "lengthscales"),
              "noise_variance": ("likelihood", "variance")}

    def __init__(self, cfg: Dict, inputs, device: torch.device):
        self.attach(cfg, inputs)
        from cggp_tpu_torch.models.cggp import CGGP
        from cggp_tpu_torch.ops.cg import ConjugateGradient
        from cggp_tpu_torch.ops.kernels import kernel_by_name

        model_cfg = cfg["model"]
        self.num_probes = int(model_cfg["num_probes"])
        self.model = CGGP(
            kernel=kernel_by_name(model_cfg["kernel"]), num_data=int(inputs.x.shape[0]),
            conjugate_gradient=ConjugateGradient(
                float(model_cfg["error_threshold"]), matvec_impl=model_cfg["matvec_impl"],
                relative_threshold=bool(model_cfg["relative_threshold"])),
            num_probes=self.num_probes, precondition=model_cfg["precondition"],
            logdet_variant=model_cfg["logdet_variant"],
            fuse_kl_solves=bool(model_cfg["fuse_kl_solves"]))
        self.params = self.model.init_params(
            inputs.z, pseudo_u=inputs.u, cluster_counts=inputs.counts,
            variance=float(inputs.kernel_variance), lengthscales=inputs.lengthscales,
            noise_variance=float(inputs.noise_variance), dtype=torch.float32, device=device)
        self.m_real = inputs.m

    def attach(self, cfg: Dict, inputs) -> None:
        """Keep the inputs and load the configuration's reference."""
        self.inputs = inputs
        self.reference = harness.load_module(
            harness.ROOT / cfg["reference"], f"gpbench_reference_{Path(cfg['reference']).stem}")

    def leaf(self, tree: Dict, name: str) -> torch.Tensor:
        section, key = self.LEAVES[name]
        return tree[section][key]

    def loss_fn(self, params, batch, key):
        return self.model.training_loss(params, batch, key)

    def trainable_mask(self):
        return self.model.trainable_mask(self.params)

    def reference_probes(self, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step's (trace, logdet) probes as the program draws them from
        ``gen`` (``torch.randint(0, 2)`` mapped to +-1, [M, P], trace first),
        in the reference's [M_real, P] layout."""
        shape = (self.m_real, self.num_probes)
        return tuple(2.0 * torch.randint(0, 2, shape, generator=gen, device=gen.device) - 1.0
                     for _ in range(2))

    def reference_steps(self, first_index: torch.Tensor, lr: float, precision: str) -> Dict:
        """The reference's Adam over the batches ``first_index`` [steps,
        batch] from the initial values, with the program's probes: the
        losses, the first step's gradients and the parameters' change."""
        inputs, ref = self.inputs, self.reference
        gen = torch.Generator(device=inputs.device).manual_seed(inputs.seeds["probes"])
        batches = [(inputs.x[idx], inputs.y[idx], *self.reference_probes(gen))
                   for idx in first_index]
        raw0 = ref.init_raw(inputs.kernel_variance, inputs.lengthscales, inputs.noise_variance,
                            precision, inputs.device)
        losses, grads, raw = ref.adam_steps(raw0, batches, inputs.z, inputs.u, inputs.counts,
                                            int(inputs.x.shape[0]), lr, precision)
        return {"losses": torch.tensor(losses, dtype=torch.float64), "grads": grads,
                "change": {n: raw[n] - raw0[n] for n in raw0}}

    def reference_predict(self, x: torch.Tensor, precision: str):
        """The reference's predictive mean and variance at ``x``."""
        inputs, ref = self.inputs, self.reference
        raw = ref.init_raw(inputs.kernel_variance, inputs.lengthscales, inputs.noise_variance,
                           precision, inputs.device)
        return ref.predict(raw, inputs.z, inputs.u, inputs.counts, x, precision)

    @contextlib.contextmanager
    def recording_solves(self):
        """Every CG solve's ``(rows, m, steps tensor)`` while active."""
        from cggp_tpu_torch.ops import cg as cg_module

        solves: List = []
        impl = cg_module._cg_dense_impl

        def recording(*args):
            solution, stats = impl(*args)
            matrix, rhs = args[7], args[8]
            solves.append((int(rhs.shape[-2]), int(matrix.shape[-1]), stats.steps))
            return solution, stats

        cg_module._cg_dense_impl = recording
        try:
            yield solves
        finally:
            cg_module._cg_dense_impl = impl

    def posterior(self, solver: str):
        return self.model.posterior(self.params, solver=solver)

    def serve(self, cache, xq: torch.Tensor, batch_size):
        from cggp_tpu_torch.training.optimize import predict_in_batches

        return predict_in_batches(self.model, self.params, xq, batch_size=batch_size,
                                  posterior=cache)

"""Minimum-volume NMF: KL reconstruction + logdet volume penalty.

API parity with the reference MvNMF (models/mvnmf.py:95-218): hyperparameters
lam/delta, H update then W update with a backtracking line search whose step
scale gamma persists across iterations (reset to 1.0 per fit). The whole
iteration - including the data-dependent backtracking - compiles to XLA
(nested lax.while_loop inside the engine's convergence loop).
"""

from __future__ import annotations

from typing import Literal

import jax.numpy as jnp
import numpy as np

from ..ops import klnmf as klnmf_ops
from ..ops import mvnmf as ops
from .standard_nmf import StandardNMF


class MvNMF(StandardNMF):
    """Volume-regularized NMF (Leplat, Gillis & Ang 2020) with the
    generalized KL divergence."""

    def __init__(
        self,
        n_signatures: int = 1,
        init_method: str = "nndsvd",
        lam: float = 1.0,
        delta: float = 1.0,
        min_iterations: int = 500,
        max_iterations: int = 10000,
        conv_test_freq: int = 10,
        tol: float = 1e-7,
        dtype: str | None = None,
    ):
        super().__init__(
            n_signatures, init_method, min_iterations, max_iterations,
            conv_test_freq, tol, dtype=dtype,
        )
        self.lam = lam
        self.delta = delta
        self._gamma = 1.0
        # line-search trial batching (ops.line_search trial_batch): None =
        # auto (currently serial). Batched trials (e.g. 8) evaluate the
        # shrink candidates as one vmapped objective pass - bitwise-equal
        # to the serial search on CPU, but on an accelerator the batched
        # matmuls' reduction-order ulps can steer the f32 trajectory to a
        # DIFFERENT convergence stop than the CPU trajectory. Trajectory
        # fidelity wins by default; opt in explicitly for
        # throughput-over-parity workloads.
        self._line_search_trial_batch: int | None = None

    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "minimize"

    def objective_function(self) -> float:
        return float(
            ops.kl_divergence_penalized(
                self.adata.X.T,
                self.asignatures.X.T,
                self.adata.obsm["exposures"].T,
                self.lam,
                self.delta,
            )
        )

    def _setup_fitting_parameters(self, fitting_kwargs=None) -> None:
        self._gamma = 1.0

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        params, data = super()._device_state()
        params["gamma"] = jnp.asarray(self._gamma, dtype=params["W"].dtype)
        return params, data

    def _absorb_params(self, params) -> None:
        super()._absorb_params(params)
        self._gamma = float(params["gamma"])

    def _resolve_trial_batch(self) -> int:
        """Auto policy: serial trials (see the ctor comment - batched
        trials can land on a different f32 convergence stop on an
        accelerator; parity wins by default)."""
        if self._line_search_trial_batch is not None:
            return max(1, int(self._line_search_trial_batch))
        return 1

    def _step_cache_key(self, given_parameters=None):
        # the step bakes n_given, lam/delta and the resolved trial batch
        return (
            "mvnmf", self._n_given_signatures(given_parameters),
            float(self.lam), float(self.delta),
            self._resolve_trial_batch(),
        )

    def _build_step(self, given_parameters=None):
        n_given = self._n_given_signatures(given_parameters)
        lam, delta = self.lam, self.delta
        freeze_W = n_given == self.n_signatures
        trial_batch = self._resolve_trial_batch()

        def update_fn(params, data):
            X = data["X"]
            H = klnmf_ops.update_H(X, params["W"], params["H"])
            if freeze_W:
                return {"W": params["W"], "H": H, "gamma": params["gamma"]}
            W_unconstrained = ops.update_W_unconstrained(
                X, params["W"], H, lam, delta, n_given
            )
            W, H, gamma = ops.line_search(
                X, params["W"], H, lam, delta, params["gamma"],
                W_unconstrained, trial_batch=trial_batch,
            )
            return {"W": W, "H": H, "gamma": gamma}

        def objective_fn(params, data):
            return ops.kl_divergence_penalized(
                data["X"], params["W"], params["H"], lam, delta
            )

        return update_fn, objective_fn

    # eager single-step helpers mirroring the reference's test surface
    def _update_H(self) -> None:
        H = klnmf_ops.update_H(
            self.adata.X.T, self.asignatures.X.T, self.adata.obsm["exposures"].T
        )
        self.adata.obsm["exposures"] = np.asarray(H).T

    def _update_W(self, n_given_signatures: int = 0) -> None:
        if n_given_signatures == self.n_signatures:
            return
        X = self.adata.X.T
        W = self.asignatures.X.T
        H = self.adata.obsm["exposures"].T
        W_unconstrained = ops.update_W_unconstrained(
            X, W, H, self.lam, self.delta, n_given_signatures
        )
        W_new, H_new, gamma = ops.line_search(
            X, W, H, self.lam, self.delta, self._gamma, W_unconstrained
        )
        self.asignatures.X = np.asarray(W_new).T
        self.adata.obsm["exposures"] = np.asarray(H_new).T
        self._gamma = float(gamma)

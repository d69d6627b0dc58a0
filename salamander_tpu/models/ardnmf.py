"""ARDNMF: KL-NMF with automatic relevance determination (rank inference).

Beyond-reference model family: the reference package selects the number of
signatures by scanning ranks with repeated fits (tutorial.ipynb cell 70;
this package's parallel.rank_scan_klnmf). ARDNMF instead fits ONCE at an
over-complete rank ``n_signatures = K_max`` and lets inverse-gamma relevance
priors (Tan & Fevotte 2013, beta=1) shrink unsupported components to the
EPSILON floor, so the effective rank is read off the fitted relevance
vector. See ops/ardnmf.py for the objective and update rules.

API surface follows the package's StandardNMF conventions (fit / transform /
plot_* / save_model round-trips); the ARD extras are:

  model.lambdas               per-signature relevance lambda_k (pd.Series)
  model.relevance             normalized excess over the prior resting value
  model.n_active_signatures   inferred rank
  model.active_signatures()   names of the data-supported signatures
  model.prune()               drop pruned components from the containers

Unlike KLNMF, fitted ARD signatures are NOT column-normalized - their scale
carries the relevance information. ``prune(normalize=True)`` (the default)
renormalizes the surviving signatures to sum one and pushes the scale into
the exposures (WH-invariant), restoring the package-wide convention for
downstream analysis/plotting.
"""

from __future__ import annotations

from typing import Literal

import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..ops import ardnmf as ops
from .standard_nmf import StandardNMF

_LAMBDA_KEY = "ard_lambda"


class ARDNMF(StandardNMF):
    """Decompose counts X into W @ H by minimizing generalized KL divergence
    with component-wise automatic relevance determination: fit with
    ``n_signatures`` set to an upper bound and read the inferred signature
    count from ``n_active_signatures``.

    Parameters beyond the shared NMF hyperparameters:

    prior : 'L1' (exponential priors on signatures/exposures - the default)
        or 'L2' (half-normal). Measured on planted Poisson cohorts: 'L1'
        prunes sharply through realistic noise; 'L2' separates less
        decisively on noisy data (components it should drop can linger at
        small-but-nonzero relevance) - prefer 'L1' unless the smoother
        half-normal shrinkage is specifically wanted.
    a : inverse-gamma shape of the relevance hyperprior; with the
        moment-matched default b, SMALLER a means stronger pruning.
        (Profiling out lambda_k leaves an effective penalty c*log(f_k + b)
        on each component's mass f_k, whose shrinkage slope at small mass
        is c/b ~ (V+D+a)/(a*sqrt(mean(X)/K)) - decreasing in a. Measured:
        a in [2.5, 5] recovers planted ranks exactly; a >= 10 stops pruning
        at all.) Needs a > 2 for the default b under 'L1', a > 1 under 'L2'.
    b : inverse-gamma scale. None (default) resolves it from the data at fit
        time by moment matching (ops/ardnmf.default_b) and records the value
        in ``model.b_resolved_``; note ``transform()`` re-resolves b on the
        new cohort.

    The default iteration cap is 20000 (double the package-wide 10000):
    ARD shrinkage converges more slowly than plain KLNMF - planted-cohort
    fits under the default tolerance use ~10000-18000 iterations.
    """

    def __init__(
        self,
        n_signatures: int = 10,
        prior: str = "L1",
        a: float = 5.0,
        b: float | None = None,
        init_method: str = "nndsvd",
        min_iterations: int = 500,
        max_iterations: int = 20000,
        conv_test_freq: int = 10,
        tol: float = 1e-7,
        dtype: str | None = None,
    ):
        super().__init__(
            n_signatures, init_method, min_iterations, max_iterations,
            conv_test_freq, tol, dtype=dtype,
        )
        if prior not in ops.PRIORS:
            raise ValueError(
                f"Unknown ARD prior {prior!r}: use one of {ops.PRIORS}."
            )
        if a <= 0:
            raise ValueError(f"The hyperparameter a must be positive, got {a}.")
        if b is not None and b <= 0:
            raise ValueError(f"The hyperparameter b must be positive, got {b}.")
        self.prior = prior
        self.a = float(a)
        self.b = None if b is None else float(b)
        self.b_resolved_ = float("nan")

    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "minimize"

    def objective_function(self) -> float:
        params, data = self._device_state()
        return float(ops.ard_objective(
            data["X"], params["W"], params["H"], params["lam"],
            data["ard_ab"], self.prior,
        ))

    # ------------------------------------------------------------------ #
    # initialization
    # ------------------------------------------------------------------ #
    def _resolve_b(self) -> float:
        if self.b is not None:
            return self.b
        return ops.default_b(
            self.prior, float(np.mean(self.adata.X)), self.n_signatures,
            self.a,
        )

    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        import jax

        super()._initialize(given_parameters, init_kwargs)
        self.b_resolved_ = self._resolve_b()

        # rebalance + closed-form lambda0 (ops.init_params), pinned to the
        # host CPU backend: _initialize runs eagerly, and each eager op on
        # an accelerator is one more dispatch and transfer
        with jax.default_device(jax.devices("cpu")[0]):
            params = ops.init_params(
                self.asignatures.X.T.astype(np.float64),
                self.adata.obsm["exposures"].T.astype(np.float64),
                np.array([self.a, self.b_resolved_]),
                self.prior,
                self._n_given_signatures(given_parameters),
            )
        self.asignatures.X = np.asarray(params["W"]).T
        self.adata.obsm["exposures"] = np.asarray(params["H"]).T
        self.asignatures.obs[_LAMBDA_KEY] = np.asarray(params["lam"])

    def _setup_fitting_parameters(self, fitting_kwargs=None) -> None:
        if fitting_kwargs:
            raise ValueError(
                "ARDNMF takes no fitting keyword arguments (its "
                "hyperparameters prior/a/b are constructor arguments); got "
                f"{sorted(fitting_kwargs)}."
            )

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_params(self):
        params = super()._device_params()
        dtype = params["W"].dtype
        params["lam"] = jnp.asarray(
            np.asarray(self.asignatures.obs[_LAMBDA_KEY]), dtype
        )
        return params

    def _device_state(self):
        params, data = super()._device_state()
        data["ard_ab"] = jnp.asarray(
            [self.a, self.b_resolved_], data["X"].dtype
        )
        return params, data

    def _absorb_params(self, params) -> None:
        super()._absorb_params(params)
        self.asignatures.obs[_LAMBDA_KEY] = np.asarray(params["lam"])

    def _check_warm_start(self, given_parameters) -> None:
        super()._check_warm_start(given_parameters)
        try:
            np.asarray(self.asignatures.obs[_LAMBDA_KEY])
            ok = np.isfinite(float(self.b_resolved_))
        except (AttributeError, KeyError, TypeError):
            ok = False
        if not ok:
            raise ValueError(
                "warm_start=True for ARDNMF needs the previous fit's "
                "relevance state (per-signature lambda + resolved b); "
                "fit once without warm_start first."
            )

    def _build_step(self, given_parameters=None):
        return ops.make_step_functions(
            self.prior, self._n_given_signatures(given_parameters)
        )

    def _step_cache_key(self, given_parameters=None):
        # the step bakes the prior and n_given (a/b ride in data["ard_ab"])
        return (
            "ardnmf", self.prior,
            self._n_given_signatures(given_parameters),
        )

    # ------------------------------------------------------------------ #
    # relevance / rank inference
    # ------------------------------------------------------------------ #
    def _require_fitted(self, what: str) -> None:
        if not getattr(self, "_is_fitted", False):
            raise ValueError(f"{what} requires a fitted model.")

    @property
    def lambdas(self) -> pd.Series:
        """Per-signature relevance parameter lambda_k."""
        self._require_fitted("lambdas")
        return pd.Series(
            np.asarray(self.asignatures.obs[_LAMBDA_KEY]),
            index=self.signature_names, name="lambda",
        )

    @property
    def relevance(self) -> pd.Series:
        """Normalized relevance excess (f(w_k)+f(h_k))/b: ~0 for pruned
        components, O(1) or larger for data-supported ones."""
        self._require_fitted("relevance")
        excess = ops.relevance_excess(
            np.asarray(self.asignatures.obs[_LAMBDA_KEY]),
            np.array([self.a, self.b_resolved_]),
            self.prior, self.adata.n_vars, self.adata.n_obs,
        )
        return pd.Series(excess, index=self.signature_names,
                         name="relevance")

    def active_signatures_mask(self, active_tol: float = 1e-2) -> np.ndarray:
        """Boolean (K,) mask of data-supported signatures: relevance excess
        at least `active_tol` times the most relevant component's."""
        self._require_fitted("active_signatures_mask()")
        return ops.active_components(
            np.asarray(self.asignatures.obs[_LAMBDA_KEY]),
            np.array([self.a, self.b_resolved_]),
            self.prior, self.adata.n_vars, self.adata.n_obs,
            active_tol=active_tol,
        )

    def active_signatures(self, active_tol: float = 1e-2) -> list[str]:
        mask = self.active_signatures_mask(active_tol)
        return [name for name, keep in zip(self.signature_names, mask) if keep]

    @property
    def n_active_signatures(self) -> int:
        """The inferred signature count (at the default active_tol)."""
        return int(self.active_signatures_mask().sum())

    def plot_relevance(self, active_tol: float = 1e-2,
                       outfile: str | None = None, **kwargs):
        """Bar plot of the relevance spectrum (log scale) with the
        active/pruned threshold - the visual rank readout."""
        from .. import plot as pl
        import matplotlib.pyplot as plt

        ax = pl.relevance(self, active_tol=active_tol, **kwargs)
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax

    def prune(self, active_tol: float = 1e-2, normalize: bool = True
              ) -> "ARDNMF":
        """Drop pruned components from the containers in place (signatures,
        exposures, relevance), keeping the reconstruction W @ H numerically
        unchanged up to the discarded components' EPSILON-floor mass.

        normalize=True additionally rescales the surviving signatures to
        sum one, pushing the scale into the exposures (exactly
        WH-invariant) - the package-wide signature convention, so pruned
        models feed plotting/matching/stability tooling like any other
        model's. Returns self.
        """
        self._require_fitted("prune()")
        mask = self.active_signatures_mask(active_tol)
        keep = np.flatnonzero(mask)
        self.asignatures = self.asignatures[keep, :].copy()
        self.adata.obsm["exposures"] = self.adata.obsm["exposures"][:, keep]
        self.n_signatures = int(keep.size)
        if normalize:
            W = self.asignatures.X.T  # (V, k)
            scale = W.sum(axis=0)
            self.asignatures.X = (W / scale).T
            self.adata.obsm["exposures"] = (
                self.adata.obsm["exposures"] * scale[None, :]
            )
            # the rescale moves each component's mass between w_k and h_k,
            # so the stored lambdas must be re-minimized at the new point
            # (closed form (f(w_k)+f(h_k)+b)/c; host numpy on purpose) -
            # otherwise lambdas/relevance/objective_function go stale
            W = self.asignatures.X.T
            H = self.adata.obsm["exposures"].T
            if self.prior == "L1":
                f_norms = W.sum(axis=0) + H.sum(axis=1)
            else:
                f_norms = 0.5 * ((W**2).sum(axis=0) + (H**2).sum(axis=1))
            c = ops.prior_constant(
                self.prior, self.adata.n_vars, self.adata.n_obs, self.a
            )
            self.asignatures.obs[_LAMBDA_KEY] = (
                (f_norms + self.b_resolved_) / c
            )
        # stale caches of the pre-prune rank
        self._invalidate_derived(self.adata)
        return self

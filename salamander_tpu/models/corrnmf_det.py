"""Deterministic batch variational EM for correlated NMF.

Update-cycle order matches the reference CorrNMFDet exactly
(models/corrnmf_det.py:157-169), which is observable in the golden traces:
  1 sample scalings (closed form)
  2 exposures from (possibly updated) scalings + embeddings
  3 aux sufficient statistic
  4 signature scalings (closed form)
  5 embeddings: signatures to convergence, then samples with the updated
    signature embeddings, capped at 3 Newton steps (scipy maxiter=3 twin)
  6 variance from the fresh embeddings
  7 signatures via the KL multiplicative W update with step-2 exposures

The reference runs step 5 as a Python loop of scipy Newton-CG calls per row -
its dominant cost; here both sides are single vmap-batched Newton solves. The
ELBO reported during fitting uses the step-2 exposures (as the reference's
container state does), so objective traces are comparable iteration for
iteration.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from ..engine.transfer import fetch_pytree
from ..ops import corrnmf as ops
from ..ops import klnmf as klnmf_ops
from .corrnmf import CorrNMF

SIGNATURE_NEWTON_ITERS = 100  # effectively to-convergence (quadratic)
SAMPLE_NEWTON_ITERS = 3       # the reference's scipy options={"maxiter": 3}

# module-level so repeated fit_minibatch calls reuse one trace cache
import jax  # noqa: E402

_exposures_jit = jax.jit(ops.compute_exposures)


class CorrNMFDet(CorrNMF):
    """Deterministic correlated NMF (Paisley, Blei & Jordan 2014 variant)."""

    @property
    def _fits_on_host(self) -> bool:
        # newton_cg_compat runs the reference's exact scipy Newton-CG per
        # embedding row; the whole fit loop then runs host-side
        return self.newton_cg_compat

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        dtype = self._device_dtype
        data = {"X": jnp.asarray(self.adata.X, dtype)}  # (D, V), samples as rows
        return self._device_params(), data

    def _device_params(self, include_exposures: bool = True):
        """The parameter pytree alone - no count-matrix upload. The
        streaming fit path needs this: uploading X is exactly what a
        beyond-HBM cohort cannot do."""
        dtype = self._device_dtype
        params = {
            "signatures": jnp.asarray(self.asignatures.X, dtype),  # (K, V)
            "signature_scalings": jnp.asarray(
                np.asarray(self.asignatures.obs["scalings"], dtype=float), dtype
            ),
            "sample_scalings": jnp.asarray(
                np.asarray(self.adata.obs["scalings"], dtype=float), dtype
            ),
            "signature_embeddings": jnp.asarray(
                self.asignatures.obsm["embeddings"], dtype
            ),
            "sample_embeddings": jnp.asarray(self.adata.obsm["embeddings"], dtype),
            "variance": jnp.asarray(float(self.variance), dtype),
        }
        if include_exposures:
            params["exposures"] = jnp.asarray(
                self.adata.obsm["exposures"], dtype
            )
        return params

    def _absorb_params(self, params) -> None:
        self.asignatures.X = np.asarray(params["signatures"])
        self.asignatures.obs["scalings"] = np.asarray(params["signature_scalings"])
        self.adata.obs["scalings"] = np.asarray(params["sample_scalings"])
        self.asignatures.obsm["embeddings"] = np.asarray(
            params["signature_embeddings"]
        )
        self.adata.obsm["embeddings"] = np.asarray(params["sample_embeddings"])
        self.variance = float(params["variance"])
        self.adata.obsm["exposures"] = np.asarray(params["exposures"])

    def _given_flags(self, given_parameters) -> dict[str, Any]:
        """Freeze flags derived from a given_parameters dict — the single
        source of truth for which parameters fit and fit_minibatch hold
        fixed."""
        given = given_parameters or {}
        n_given = 0
        if "asignatures" in given:
            n_given = int(given["asignatures"].n_obs)
        return {
            "n_given": n_given,
            "fix_signatures": n_given == self.n_signatures,
            "fix_signature_scalings": "signature_scalings" in given,
            "fix_sample_scalings": "sample_scalings" in given,
            "fix_signature_embeddings": "signature_embeddings" in given,
            "fix_sample_embeddings": "sample_embeddings" in given,
            "fix_variance": "variance" in given,
        }

    def _step_cache_key(self, given_parameters=None):
        # the step bakes only the given-parameter freeze flags (values
        # ride in the params pytree)
        flags = self._given_flags(given_parameters)
        return ("corrnmf_det",) + tuple(sorted(flags.items()))

    def _build_step(self, given_parameters=None):
        flags = self._given_flags(given_parameters)
        n_given = flags["n_given"]
        fix_signatures = flags["fix_signatures"]
        fix_sig_scalings = flags["fix_signature_scalings"]
        fix_smp_scalings = flags["fix_sample_scalings"]
        fix_sig_embeddings = flags["fix_signature_embeddings"]
        fix_smp_embeddings = flags["fix_sample_embeddings"]
        fix_variance = flags["fix_variance"]

        def update_fn(params, data):
            X = data["X"]
            signatures = params["signatures"]
            sig_scal = params["signature_scalings"]
            smp_scal = params["sample_scalings"]
            sig_emb = params["signature_embeddings"]
            smp_emb = params["sample_embeddings"]
            variance = params["variance"]

            if not fix_smp_scalings:
                smp_scal = ops.update_sample_scalings(
                    X, sig_scal, sig_emb, smp_emb
                )
            exposures = ops.compute_exposures(sig_scal, smp_scal, sig_emb, smp_emb)
            aux = ops.compute_aux(X, signatures, exposures)
            if not fix_sig_scalings:
                sig_scal = ops.update_signature_scalings(
                    aux, smp_scal, sig_emb, smp_emb
                )
            if not fix_sig_embeddings:
                sig_emb = ops.update_embeddings(
                    sig_emb, smp_emb, sig_scal, smp_scal, variance, aux,
                    max_iter=SIGNATURE_NEWTON_ITERS,
                )
            if not fix_smp_embeddings:
                smp_emb = ops.update_embeddings(
                    smp_emb, sig_emb, smp_scal, sig_scal, variance, aux.T,
                    max_iter=SAMPLE_NEWTON_ITERS,
                )
            if not fix_variance:
                variance = ops.update_variance(sig_emb, smp_emb)
            if not fix_signatures:
                W = klnmf_ops.update_W(
                    X.T, signatures.T, exposures.T, n_given_signatures=n_given
                )
                signatures = W.T
            return {
                "signatures": signatures,
                "signature_scalings": sig_scal,
                "sample_scalings": smp_scal,
                "signature_embeddings": sig_emb,
                "sample_embeddings": smp_emb,
                "variance": variance,
                "exposures": exposures,
            }

        def objective_fn(params, data):
            return ops.elbo_corrnmf(
                data["X"],
                params["signatures"],
                params["exposures"],
                params["signature_embeddings"],
                params["sample_embeddings"],
                params["variance"],
            )

        return update_fn, objective_fn

    # ------------------------------------------------------------------ #
    # stochastic (minibatch) EM
    # ------------------------------------------------------------------ #
    def fit_minibatch(
        self,
        adata,
        batch_size: int = 128,
        n_steps: int = 2000,
        eval_freq: int = 50,
        forgetting: float = 0.7,
        delay: float = 1.0,
        seed: int = 0,
        signature_newton_iters: int = 4,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        streaming: bool = False,
        eval_chunk: int = 8192,
        mesh=None,
    ) -> "CorrNMFDet":
        """Fit with stochastic (minibatch) variational EM instead of
        full-batch cycles - for cohorts whose sample count makes full EM
        cycles too slow: per-step compute is amortized O(batch_size) while
        a full-batch cycle is O(n_samples).

        streaming=False (default) keeps the count matrix device-resident.
        streaming=True keeps X HOST-resident and uploads each minibatch
        (and, for the ELBO trace, eval_chunk-row evaluation chunks) on the
        fly - the single-chip beyond-HBM path: only the O(n_samples)
        per-sample parameters live in device memory, so cohorts whose
        counts exceed HBM fit end-to-end. Given the same seed, the two
        placements draw identical minibatch sequences and produce
        bitwise-identical parameters (ops/svi.py run_svi_streaming) -
        when comparing two separate calls, also pass init_kwargs
        {"seed": ...}: the CorrNMF embedding initialization is otherwise
        unseeded (reference semantics, initialize.py:365-377).
        Integer-dtype count matrices are kept compact on the host in
        streaming mode (adata.X is NOT clipped in place; the EPSILON clip
        is applied to each uploaded batch instead). Pass eval_freq=0 to
        skip the O(n_samples) full-data ELBO evaluations.

        Each step refreshes `batch_size` samples' local parameters with the
        exact batch M-steps and updates the global parameters from
        Robbins-Monro running averages of minibatch-scaled sufficient
        statistics (rho_t = (t + delay)^(-forgetting); see ops/svi.py).
        With batch_size >= n_samples, delay=1, and signature_newton_iters
        raised to the full-batch cap (100), the first step reduces exactly
        to one deterministic EM cycle; at the default signature_newton_iters
        (4, plenty under rho-damping) it is the same cycle with a truncated
        signature-embedding Newton solve.

        batch_size is clamped to n_samples, so the defaults work on small
        cohorts. Runs a fixed `n_steps` step budget (stochastic traces have
        no meaningful relative-change convergence test); the full-data ELBO
        is recorded every `eval_freq` steps into history.

        Practical guidance: full-batch `fit` finds better optima for any
        cohort where its O(n_samples) cycles are acceptable - reach for
        this path when they are not. Raising `delay` (20-100) tempers the
        early noisy steps and preserves more of the initialization basin.

        mesh (optional) shards the resident path's sample axis across
        devices (X, sample scalings/embeddings); the streaming path is
        host-driven single-device and rejects it.
        """
        from ..ops import svi

        if self.newton_cg_compat:
            raise ValueError(
                "fit_minibatch does not support newton_cg_compat=True: the "
                "scipy-exact host path has no minibatch twin, so compat-mode "
                "audit traces would silently get device-Newton numerics. "
                "Use fit() for auditable traces."
            )
        if mesh is not None and streaming:
            raise ValueError(
                "mesh= and streaming=True are mutually exclusive: streaming "
                "keeps the counts host-resident and uploads minibatches to "
                "ONE device. Shard a resident fit, or stream unsharded."
            )

        if streaming:
            self._setup_adata_streaming(adata)
        else:
            self._setup_adata(adata)
        self._initialize(given_parameters, init_kwargs)
        self._setup_fitting_parameters(None)

        flags = self._given_flags(given_parameters)

        n_samples = int(self.adata.n_obs)
        config = svi.SVIConfig(
            batch_size=min(int(batch_size), n_samples),
            forgetting=forgetting,
            delay=delay,
            signature_newton_iters=signature_newton_iters,
            sample_newton_iters=SAMPLE_NEWTON_ITERS,
        )
        step_kwargs = dict(
            n_samples=n_samples,
            config=config,
            n_given_signatures=flags["n_given"],
            fix_signature_scalings=flags["fix_signature_scalings"],
            fix_sample_scalings=flags["fix_sample_scalings"],
            fix_signature_embeddings=flags["fix_signature_embeddings"],
            fix_sample_embeddings=flags["fix_sample_embeddings"],
            fix_variance=flags["fix_variance"],
        )
        import jax

        if streaming:
            params = self._device_params(include_exposures=False)
            dtype = np.dtype(params["signatures"].dtype)
            X_host = self.adata.X

            def get_batch(indices):
                return np.asarray(X_host[indices], dtype).clip(
                    np.finfo(np.float32).eps
                )

            objective_fn = None
            if eval_freq:
                objective_fn = svi.make_streamed_objective(
                    svi.corrnmf_elbo_stream_chunk,
                    svi.corrnmf_elbo_stream_rest,
                    get_batch, n_samples, chunk_size=eval_chunk,
                )
            state0 = svi.svi_init(params, streaming=True)
            state, elbo_trace = svi.run_svi_streaming(
                svi.make_svi_batch_step(**step_kwargs), state0, get_batch,
                n_samples, config.batch_size, jax.random.PRNGKey(seed),
                n_steps, eval_freq, objective_fn,
                refresh_fn=svi.refresh_sample_usq,
            )
        else:
            params, data = self._device_state()
            if mesh is not None:
                params, data = self._shard_state(params, data, mesh)
            step_fn = svi.make_svi_step(**step_kwargs)
            state0 = svi.svi_init(params)
            state, elbo_trace = svi.run_svi_guarded(
                step_fn, state0, data["X"], jax.random.PRNGKey(seed),
                n_steps, eval_freq,
                batch_size=config.batch_size, n_samples=n_samples,
            )
        final = dict(state.params)
        final["exposures"] = _exposures_jit(
            final["signature_scalings"],
            final["sample_scalings"],
            final["signature_embeddings"],
            final["sample_embeddings"],
        )
        # one batched device->host transfer for params + trace
        final, elbo_trace = fetch_pytree((final, elbo_trace))
        self._absorb_params(final)
        if history:
            self.history["objective_function"] = list(np.asarray(elbo_trace))
            self.history["n_iterations"] = int(n_steps)
            # plot_history x-axis spacing: evals are eval_freq steps apart
            self.history["step_freq"] = int(eval_freq)
        self._is_fitted = True
        return self

    # ------------------------------------------------------------------ #
    # eager per-update methods (test/inspection surface, reference-named)
    # ------------------------------------------------------------------ #
    def _compute_aux(self) -> np.ndarray:
        return np.asarray(
            ops.compute_aux(
                self.adata.X, self.asignatures.X, self.adata.obsm["exposures"]
            )
        )

    def update_sample_scalings(self, given_parameters=None) -> None:
        given = given_parameters or {}
        if "sample_scalings" not in given:
            self.adata.obs["scalings"] = np.asarray(
                ops.update_sample_scalings(
                    self.adata.X,
                    np.asarray(self.asignatures.obs["scalings"]),
                    self.asignatures.obsm["embeddings"],
                    self.adata.obsm["embeddings"],
                )
            )

    def update_signature_scalings(self, aux, given_parameters=None) -> None:
        given = given_parameters or {}
        if "signature_scalings" not in given:
            self.asignatures.obs["scalings"] = np.asarray(
                ops.update_signature_scalings(
                    aux,
                    np.asarray(self.adata.obs["scalings"]),
                    self.asignatures.obsm["embeddings"],
                    self.adata.obsm["embeddings"],
                )
            )

    def update_signature_embeddings(self, aux) -> None:
        if self.newton_cg_compat:
            self.asignatures.obsm["embeddings"] = ops.update_embeddings_newton_cg(
                self.asignatures.obsm["embeddings"],
                self.adata.obsm["embeddings"],
                np.asarray(self.asignatures.obs["scalings"]),
                np.asarray(self.adata.obs["scalings"]),
                self.variance,
                aux,
                max_iter=None,  # scipy default, as the reference's call
            )
            return
        self.asignatures.obsm["embeddings"] = np.asarray(
            ops.update_embeddings(
                self.asignatures.obsm["embeddings"],
                self.adata.obsm["embeddings"],
                np.asarray(self.asignatures.obs["scalings"]),
                np.asarray(self.adata.obs["scalings"]),
                self.variance,
                aux,
                max_iter=SIGNATURE_NEWTON_ITERS,
            )
        )

    def update_sample_embeddings(self, aux) -> None:
        if self.newton_cg_compat:
            self.adata.obsm["embeddings"] = ops.update_embeddings_newton_cg(
                self.adata.obsm["embeddings"],
                self.asignatures.obsm["embeddings"],
                np.asarray(self.adata.obs["scalings"]),
                np.asarray(self.asignatures.obs["scalings"]),
                self.variance,
                np.asarray(aux).T,
                max_iter=SAMPLE_NEWTON_ITERS,
            )
            return
        self.adata.obsm["embeddings"] = np.asarray(
            ops.update_embeddings(
                self.adata.obsm["embeddings"],
                self.asignatures.obsm["embeddings"],
                np.asarray(self.adata.obs["scalings"]),
                np.asarray(self.asignatures.obs["scalings"]),
                self.variance,
                np.asarray(aux).T,
                max_iter=SAMPLE_NEWTON_ITERS,
            )
        )

    def update_embeddings(self, aux, given_parameters=None) -> None:
        given = given_parameters or {}
        if "signature_embeddings" not in given:
            self.update_signature_embeddings(aux)
        if "sample_embeddings" not in given:
            self.update_sample_embeddings(aux)

    def update_variance(self, given_parameters=None) -> None:
        given = given_parameters or {}
        if "variance" not in given:
            self.variance = float(
                ops.update_variance(
                    self.asignatures.obsm["embeddings"],
                    self.adata.obsm["embeddings"],
                )
            )

    def update_signatures(self, given_parameters=None) -> None:
        given = given_parameters or {}
        n_given = given["asignatures"].n_obs if "asignatures" in given else 0
        W = klnmf_ops.update_W(
            self.adata.X.T,
            self.asignatures.X.T,
            self.adata.obsm["exposures"].T,
            n_given_signatures=n_given,
        )
        self.asignatures.X = np.asarray(W).T

    def _update_parameters(self, given_parameters: dict[str, Any] | None = None):
        """One full EM cycle, eagerly (reference order, corrnmf_det:157-169)."""
        given = given_parameters or {}
        self.update_sample_scalings(given)
        self.compute_exposures()
        aux = self._compute_aux()
        self.update_signature_scalings(aux, given)
        self.update_embeddings(aux, given)
        self.update_variance(given)
        self.update_signatures(given)

"""KLNMF: weighted generalized-KL NMF with optional l1/2 exposure sparsity.

API parity with the reference KLNMF (models/klnmf.py:18-153): fitting_kwargs
'weights_kl'/'weights_lhalf' (scalar/list broadcast to per-sample arrays,
non-negativity enforced), joint update_WH per iteration, weighted-KL +
penalty objective. The per-iteration update and the convergence loop run
jitted on device.
"""

from __future__ import annotations

from typing import Any, Literal

import jax.numpy as jnp
import numpy as np

from ..engine.transfer import fetch_pytree
from ..ops import klnmf as ops
from ..utils import shape_checker, type_checker
from .standard_nmf import StandardNMF

FITTING_KWARGS = ("weights_kl", "weights_lhalf")


class KLNMF(StandardNMF):
    """Decompose counts X into W @ H by minimizing weighted generalized KL
    divergence under normalized signatures (Lee & Seung multiplicative
    updates), with an optional sparsity-inducing l1/2 exposure penalty."""

    def __init__(
        self,
        n_signatures: int = 1,
        init_method: str = "nndsvd",
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
        self.weights_kl: np.ndarray | None = None
        self.weights_lhalf: np.ndarray | None = None

    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "minimize"

    def objective_function(self) -> float:
        return float(
            ops.klnmf_objective(
                self.adata.X.T,
                self.asignatures.X.T,
                self.adata.obsm["exposures"].T,
                self.weights_kl,
                self.weights_lhalf,
            )
        )

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        params, data = super()._device_state()
        dtype = self._device_dtype
        if self.weights_kl is not None:
            data["weights_kl"] = jnp.asarray(self.weights_kl, dtype)
        if self.weights_lhalf is not None:
            data["weights_lhalf"] = jnp.asarray(self.weights_lhalf, dtype)
        return params, data

    def _build_step(self, given_parameters=None):
        return ops.make_step_functions(
            self._n_given_signatures(given_parameters)
        )

    def _step_cache_key(self, given_parameters=None):
        # the step bakes only n_given (weights ride in the data pytree)
        return ("klnmf", self._n_given_signatures(given_parameters))

    # ------------------------------------------------------------------ #
    # stochastic (minibatch) fitting: online NMF
    # ------------------------------------------------------------------ #
    def fit_minibatch(
        self,
        adata,
        batch_size: int = 128,
        n_steps: int = 2000,
        eval_freq: int = 50,
        forgetting: float = 0.51,
        delay: float = 1.0,
        seed: int = 0,
        h_inner_iters: int = 1,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        fitting_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        streaming: bool = False,
        eval_chunk: int = 8192,
        mesh=None,
    ) -> "KLNMF":
        """Fit with online (minibatch) NMF instead of full-batch cycles -
        for cohorts whose sample count makes full multiplicative-update
        sweeps too slow: per-step compute is amortized O(batch_size) while
        a full sweep is O(n_samples).

        Each step refreshes the minibatch's exposure columns with
        `h_inner_iters` exact multiplicative H updates and updates the
        signatures from a Robbins-Monro running average of the D-scaled
        expected signature counts (ops/svi.py make_klnmf_svi_step). With
        batch_size >= n_samples (it is clamped), delay=1 and
        h_inner_iters=1, the first step reduces exactly to one serial
        Lee-Seung cycle (update_H then update_W). Supports the same
        `fitting_kwargs` weights and given-signature freezing as fit().

        Runs a fixed `n_steps` budget; the full-data objective is recorded
        every `eval_freq` steps (eval_freq=0 disables the O(n_samples)
        evaluations).
        Full-batch `fit` converges better while its O(n_samples) sweeps
        are acceptable.

        streaming=False keeps the count matrix device-resident.
        streaming=True keeps X HOST-resident and uploads minibatches (and
        eval_chunk-column objective-evaluation chunks) on the fly - the
        single-device beyond-memory path: only W, H and O(batch) buffers live
        in device memory. Same seed => bitwise-identical parameters across
        the two placements (ops/svi.py run_svi_streaming); integer count
        matrices stay compact on the host (clipped per uploaded batch, not
        in place).

        The default forgetting=0.51 (the slowest Robbins-Monro-admissible
        decay) is deliberate for KLNMF: multiplicative updates converge
        slowly, so fast statistic decay (e.g. the CorrNMF default 0.7)
        freezes the signatures far from the optimum - measured on PCAWG
        SBS: +2% final KL vs full batch at forgetting=0.51 after 12k
        steps, +30% at 0.7.

        mesh (optional) shards the resident path's sample axis across
        devices (X and H); the streaming path is host-driven single-device
        and rejects it.
        """
        import jax

        from ..ops import svi

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
        self._setup_fitting_parameters(fitting_kwargs)

        n_samples = int(self.adata.n_obs)
        config = svi.SVIConfig(
            batch_size=min(int(batch_size), n_samples),
            forgetting=forgetting,
            delay=delay,
        )
        step_kwargs = dict(
            n_samples=n_samples,
            config=config,
            n_given_signatures=self._n_given_signatures(given_parameters),
            h_inner_iters=h_inner_iters,
        )
        if streaming:
            params = self._device_params()
            dtype = np.dtype(params["W"].dtype)
            X_host = self.adata.X  # (D, V); kernel orientation is (V, B)
            w_kl, w_lhalf = self.weights_kl, self.weights_lhalf

            def get_batch(indices):
                rows = np.asarray(X_host[indices], dtype).clip(
                    np.finfo(np.float32).eps
                )
                batch = {"X": np.ascontiguousarray(rows.T)}
                if w_kl is not None:
                    batch["weights_kl"] = np.asarray(w_kl[indices], dtype)
                if w_lhalf is not None:
                    batch["weights_lhalf"] = np.asarray(
                        w_lhalf[indices], dtype
                    )
                return batch

            objective_fn = None
            if eval_freq:
                objective_fn = svi.make_streamed_objective(
                    svi.klnmf_objective_stream_chunk,
                    svi.klnmf_objective_stream_rest,
                    get_batch, n_samples, chunk_size=eval_chunk,
                )
            state0 = svi.klnmf_svi_init(params, streaming=True)
            state, trace = svi.run_svi_streaming(
                svi.make_klnmf_svi_batch_step(**step_kwargs), state0,
                get_batch, n_samples, config.batch_size,
                jax.random.PRNGKey(seed), n_steps, eval_freq, objective_fn,
            )
        else:
            params, data = self._device_state()
            if mesh is not None:
                params, data = self._shard_state(params, data, mesh)
            step_fn = svi.make_klnmf_svi_step(**step_kwargs)
            state0 = svi.klnmf_svi_init(params)
            state, trace = svi.run_svi_guarded(
                step_fn, state0, data, jax.random.PRNGKey(seed),
                n_steps, eval_freq, elbo_fn=svi.klnmf_full_objective,
                batch_size=config.batch_size, n_samples=n_samples,
            )
        # one batched device->host transfer for params + trace
        params_host, trace = fetch_pytree((state.params, trace))
        self._absorb_params(params_host)
        if history:
            self.history["objective_function"] = list(np.asarray(trace))
            self.history["n_iterations"] = int(n_steps)
            # plot_history x-axis spacing: evals are eval_freq steps apart
            self.history["step_freq"] = int(eval_freq)
        self._is_fitted = True
        return self

    # ------------------------------------------------------------------ #
    # fitting kwargs
    # ------------------------------------------------------------------ #
    def _check_weights(self, weights: np.ndarray, name: str = "weights") -> None:
        type_checker(name, weights, np.ndarray)
        shape_checker(name, weights, (self.adata.n_obs,))
        if not all(weights >= 0):
            raise ValueError(
                "Only non-negative KL-divergence and sparsity penalty weights "
                "are allowed."
            )

    def _setup_fitting_parameters(
        self, fitting_kwargs: dict[str, Any] | None = None
    ) -> None:
        if fitting_kwargs is None:
            fitting_kwargs = {name: None for name in FITTING_KWARGS}

        for kwarg in fitting_kwargs:
            if kwarg not in FITTING_KWARGS:
                raise ValueError(
                    "The given fitting keyword arguments include parameters "
                    f"outside of {list(FITTING_KWARGS)}."
                )

        for name, weights in fitting_kwargs.items():
            if weights is not None:
                type_checker(name, weights, [float, int, list, np.ndarray])
                if type(weights) in [float, int]:
                    weights = weights * np.ones(self.adata.n_obs)
                if type(weights) is list:
                    weights = np.array(weights)
                self._check_weights(weights, name)
            setattr(self, name, weights)

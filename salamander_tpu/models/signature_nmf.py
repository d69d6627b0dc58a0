"""Abstract base of all signature NMF models.

API parity with the reference's SignatureNMF
(/root/reference/src/salamander/models/signature_nmf.py:31-621): the same
constructor hyperparameters, container conventions (exposures in
adata.obsm['exposures'], signatures as a second AnnData, reconstruction /
correlation helpers, Hungarian reorder, plot wrappers) and the same
convergence rule - but `fit` hands a parameter pytree to the jitted engine
instead of looping in Python.

Concrete models implement three engine hooks:
  _device_state()          -> (params pytree, data pytree)
  _build_step(given)       -> (update_fn(params, data),
                               objective_fn(params, data))
  _absorb_params(params)   -> write fitted arrays back into the containers
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Literal

import numpy as np
import pandas as pd

from .. import containers, tools as tl
from ..engine import FitConfig, make_fit_function
from ..engine.transfer import fetch_pytree
from ..initialization.methods import INIT_METHODS
from ..utils import match_signatures_pair, type_checker, value_checker

EPSILON = float(np.finfo(np.float32).eps)

DIM_REDUCTION_METHODS = ("pca", "tsne", "umap")


def resolve_dtype(dtype):
    """Validate and canonicalize a model compute dtype.

    None means 'backend default': float64 when jax x64 is enabled (the
    CPU parity configuration), float32 otherwise (the accelerator
    production configuration). Explicit float64 requires x64.
    """
    if dtype is None:
        return None
    import jax

    resolved = np.dtype(dtype)
    if resolved not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(
            f"Unsupported model dtype {dtype!r}: use 'float32' or 'float64'."
        )
    if resolved == np.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "dtype='float64' requires jax x64 "
            "(jax.config.update('jax_enable_x64', True))."
        )
    return resolved


def cast_floating(tree, dtype):
    """Cast every floating leaf of a pytree to `dtype` (None = no-op)."""
    if dtype is None:
        return tree
    import jax
    import jax.numpy as jnp

    def cast(leaf):
        leaf = jnp.asarray(leaf)
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf.astype(dtype)
        return leaf

    return jax.tree.map(cast, tree)


def segment_progress_printer():
    """The verbose=1 printer for backends that reject host callbacks: live
    reporting rides the capped-segment boundaries of a program-seconds
    budget (only long, rerouted fits have segments; short monolithic fits
    report via the post-fit trace). Single-lane fits print the
    reference's 'iteration: N; objective: X' form."""
    def progress_cb(info):
        if info["n_lanes"] == 1:
            print(
                f"iteration: {info['iteration']}; objective: "
                f"{info['objective_min']:.2f}", flush=True,
            )
        else:
            print(
                f"iteration: {info['iteration']}; objective "
                f"range: [{info['objective_min']:.2f}, "
                f"{info['objective_max']:.2f}]; lanes alive: "
                f"{info['n_alive']}/{info['n_lanes']}", flush=True,
            )
    return progress_cb


def cached_fit_runner(model, update_fn, objective_fn, config, live_verbose,
                      verbosity_freq, given_parameters, objective_dtype,
                      unroll, progress_cb):
    """Build - or reuse - the jitted fit runner for a model's fit() call.

    A fresh make_fit_function per call re-traces the whole convergence
    loop every time (seconds of host work per fit - the dominant cost of
    a small repeated fit). The cache key
    captures everything baked into the step closures (model
    hyperparameters + given-parameter structure via
    `model._step_cache_key`; counts/weights ride as jit ARGUMENTS, so
    data changes hit jit's own cache by shape/dtype/sharding). Models
    whose step bakes state the key cannot see return None from
    _step_cache_key and get a fresh (uncached) runner.
    """
    step_key = model._step_cache_key(given_parameters)
    build = lambda: make_fit_function(
        update_fn, objective_fn, config,
        verbose=live_verbose, verbosity_freq=verbosity_freq,
        unroll=unroll, progress_cb=progress_cb,
    )
    if step_key is None:
        return build()
    runner_key = (
        step_key, config, live_verbose, int(verbosity_freq), unroll,
        str(objective_dtype), progress_cb is not None,
    )
    cache = getattr(model, "_fit_runner_cache", None)
    if cache is None:
        cache = model._fit_runner_cache = {}
    run = cache.get(runner_key)
    if run is None:
        run = build()
        cache.clear()  # one live runner per model instance
        cache[runner_key] = run
    return run


def share_transform_runner_cache(parent, projector) -> None:
    """Give a transform() projector the parent's transform-runner cache.

    Every transform() call builds a FRESH projector model, so the
    per-instance fit-runner cache alone would re-trace the projector fit
    on every call (seconds of host work to score a new cohort). The
    parent keeps one cache dict shared by all projectors it creates;
    runners are stateless jit functions keyed by step STRUCTURE, and the
    frozen signature-side VALUES ride in the params pytree, so reuse
    across projectors of one parent is exact."""
    cache = getattr(parent, "_transform_runner_cache", None)
    if cache is None:
        cache = parent._transform_runner_cache = {}
    projector._fit_runner_cache = cache


def promote_objective(objective_fn, params0):
    """Evaluate the convergence objective in float64 when the platform
    allows it, regardless of the update dtype.

    With float32 updates, the objective's own resolution (~1e-7 relative)
    sits at the default convergence tolerance; measuring it in float64
    restores a meaningful convergence test at negligible cost (one upcast
    every conv_test_freq iterations). When x64 is unavailable, this is the
    identity and the engine instead floors the
    tolerance at the dtype's resolution (engine.tolerance_floor).
    """
    import jax
    import jax.numpy as jnp

    if not jax.config.jax_enable_x64:
        return objective_fn
    leaves = [
        leaf for leaf in jax.tree.leaves(params0)
        if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating)
    ]
    if all(leaf.dtype == jnp.float64 for leaf in leaves):
        return objective_fn

    def objective_fn_f64(params, data):
        return objective_fn(
            cast_floating(params, np.float64), cast_floating(data, np.float64)
        )

    return objective_fn_f64


class SignatureNMF(ABC):
    """Shared structure of all NMF models used for signature analysis."""

    # Engine hint: unroll update blocks into straight-line HLO (fast compile
    # for cheap multiplicative updates); heavy updates with inner loops
    # (CorrNMF's Newton solves) override this to False.
    _unroll_blocks = True

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
        value_checker("init_method", init_method, INIT_METHODS)
        self.n_signatures = n_signatures
        self.init_method = init_method
        self.min_iterations = min_iterations
        self.max_iterations = max_iterations
        self.conv_test_freq = conv_test_freq
        self.tol = tol
        # compute dtype of the device fit (None = backend default: float64
        # under jax x64, float32 otherwise); the convergence objective is
        # promoted to float64 whenever the platform allows.
        resolved = resolve_dtype(dtype)
        self.dtype = None if resolved is None else resolved.name

        self.adata = containers.AnnData()
        self.asignatures = containers.AnnData()
        self.history: dict[str, Any] = {}
        self._is_fitted = False

    @property
    def _device_dtype(self):
        """Resolved numpy dtype for device arrays, or None (backend default)."""
        return resolve_dtype(self.dtype)

    # ------------------------------------------------------------------ #
    # container views
    # ------------------------------------------------------------------ #
    @property
    def mutation_types(self) -> list[str]:
        return list(self.adata.var_names)

    @property
    def signature_names(self) -> list[str]:
        return list(self.asignatures.obs_names)

    @property
    def sample_names(self) -> list[str]:
        return list(self.adata.obs_names)

    @property
    def signatures(self) -> pd.DataFrame:
        return self.asignatures.to_df()

    @property
    def exposures(self) -> pd.DataFrame:
        assert (
            "exposures" in self.adata.obsm
        ), "Learning the sample exposures requires fitting the NMF model."
        return pd.DataFrame(
            self.adata.obsm["exposures"],
            index=self.sample_names,
            columns=self.signature_names,
        )

    def compute_reconstruction(self) -> None:
        self.adata.obsm["X_reconstructed"] = (
            self.adata.obsm["exposures"] @ self.asignatures.X
        )

    @property
    def data_reconstructed(self) -> pd.DataFrame:
        if "X_reconstructed" not in self.adata.obsm:
            self.compute_reconstruction()
        return pd.DataFrame(
            self.adata.obsm["X_reconstructed"],
            index=self.sample_names,
            columns=self.mutation_types,
        )

    @abstractmethod
    def compute_reconstruction_errors(self) -> None:
        """Store per-sample reconstruction errors in adata.obs."""

    @property
    def reconstruction_error(self) -> float:
        if "reconstruction_error" not in self.adata.obs:
            self.compute_reconstruction_errors()
        return float(np.sum(self.adata.obs["reconstruction_error"]))

    # ------------------------------------------------------------------ #
    # abstract model interface
    # ------------------------------------------------------------------ #
    @property
    @abstractmethod
    def objective(self) -> Literal["minimize", "maximize"]:
        """Whether the objective function is minimized or maximized."""

    @abstractmethod
    def objective_function(self) -> float:
        """The objective value at the current container state."""

    @abstractmethod
    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        """Initialize all model parameters into the containers."""

    @abstractmethod
    def _setup_fitting_parameters(self, fitting_kwargs=None) -> None:
        """Prepare additional fit-time parameters (e.g. loss weights)."""

    @abstractmethod
    def _device_state(self):
        """Return (params pytree, data pytree) for the engine."""

    @abstractmethod
    def _build_step(self, given_parameters=None):
        """Return (update_fn, objective_fn) over (params, data)."""

    def _step_cache_key(self, given_parameters=None):
        """Hashable token covering everything `_build_step` bakes into its
        closures (scalar hyperparameters and the given-parameter
        STRUCTURE), so fit() can reuse one jitted runner across calls.
        Counts/weights/given values ride as jit arguments and must not
        appear here. Return None to disable runner reuse (the safe default
        for subclasses whose step closures this base cannot see)."""
        return None

    @abstractmethod
    def _absorb_params(self, params) -> None:
        """Write fitted device params back into the containers."""

    @abstractmethod
    def plot_embeddings(self, **kwargs):
        """Plot a 2D view of the model's sample (and signature) embeddings."""

    # ------------------------------------------------------------------ #
    # fitting
    # ------------------------------------------------------------------ #
    @staticmethod
    def _invalidate_derived(adata) -> None:
        """Drop lazily-derived caches a new fit invalidates.

        `reconstruction_error` / `X_reconstructed` are computed on demand by
        the model properties and only when absent - a container carrying
        them from an earlier fit (e.g. `other_model.adata.copy()`) would
        otherwise silently serve the OLD model's values after this fit."""
        if hasattr(adata.obs, "drop"):
            adata.obs.drop(columns=["reconstruction_error"],
                           errors="ignore", inplace=True)
        adata.obsm.pop("X_reconstructed", None)

    def _setup_adata(self, adata) -> None:
        """Validate the count container and clip zeros (EPSILON floor)."""
        if not hasattr(adata, "obsm") or not hasattr(adata, "X"):
            type_checker("adata", adata, containers.AnnData)
        self.adata = adata
        self._invalidate_derived(self.adata)
        self.adata.X = self.adata.X.clip(EPSILON)

    def _setup_adata_streaming(self, adata) -> None:
        """Container setup for the host-streaming fit path.

        Float count matrices get the normal in-place EPSILON clip (so the
        streaming fit is bitwise-equal to the resident one). Integer count
        matrices are left UNTOUCHED - clipping would silently promote a
        compact uint16/int32 cohort to float64, multiplying host memory by
        4-8x at exactly the beyond-HBM scale this path exists for; the clip
        is applied per uploaded batch instead (identical values: integer
        counts cast exactly to the fit dtype and EPSILON only lifts
        zeros)."""
        if not hasattr(adata, "obsm") or not hasattr(adata, "X"):
            type_checker("adata", adata, containers.AnnData)
        self.adata = adata
        self._invalidate_derived(self.adata)
        # read the dtype WITHOUT materializing: np.asarray on a
        # lazily-backed X would load the whole matrix just to inspect it
        x_dtype = getattr(adata.X, "dtype", None)
        if x_dtype is None:
            x_dtype = np.asarray(adata.X).dtype
        if not np.issubdtype(x_dtype, np.integer):
            self.adata.X = self.adata.X.clip(EPSILON)

    def _update_parameters(self, given_parameters=None) -> None:
        """Apply one update cycle eagerly (test/inspection path)."""
        params, data = self._device_state()
        update_fn, _ = self._build_step(given_parameters)
        self._absorb_params(update_fn(params, data))

    def _fit_config(self) -> FitConfig:
        return FitConfig(
            min_iterations=self.min_iterations,
            max_iterations=self.max_iterations,
            conv_test_freq=self.conv_test_freq,
            tol=self.tol,
        )

    # ------------------------------------------------------------------ #
    # sample-axis sharding of a single fit
    # ------------------------------------------------------------------ #
    def _sample_axes(self):
        """Which axis of each _device_state leaf carries the sample (D)
        dimension, keyed by leaf name; absent/None = replicated.

        The default covers the StandardNMF state layout in kernel
        orientation (W (V,K) replicated, H (K,D) and X (V,D) on their
        trailing axis, per-sample weight vectors on axis 0); CorrNMF
        overrides for its samples-as-rows layout.
        """
        return (
            {"H": 1},                                        # params
            {"X": 1, "weights_kl": 0, "weights_lhalf": 0},   # data
        )

    def _shard_state(self, params, data, mesh):
        """device_put the fit state under `mesh`, samples sharded.

        Every leaf gets an explicit NamedSharding (replicated unless its
        name appears in _sample_axes), so jit propagates the layout and XLA
        inserts the cross-device reductions (the W-update numerator, column
        sums and objectives all reduce over D). Numerics are unchanged -
        sharded == unsharded is pinned in tests/test_sharding.py.
        """
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.mesh import SAMPLE_AXIS

        if SAMPLE_AXIS not in mesh.axis_names:
            raise ValueError(
                f"mesh has axes {mesh.axis_names}; model.fit expects a "
                f"'{SAMPLE_AXIS}' axis (parallel.make_mesh(sample_ways=...))."
            )
        param_axes, data_axes = self._sample_axes()

        def put(tree, axes):
            out = {}
            for key, leaf in tree.items():
                leaf = jnp.asarray(leaf)
                axis = axes.get(key)
                if axis is None:
                    spec = PartitionSpec()
                else:
                    spec = PartitionSpec(
                        *([None] * axis + [SAMPLE_AXIS])
                    )
                out[key] = jax.device_put(leaf, NamedSharding(mesh, spec))
            return out

        return put(params, param_axes), put(data, data_axes)

    def _check_warm_start(self, given_parameters) -> None:
        """Validate that the model/container pair carries a previous fit's
        state to resume from (warm_start=True skips initialization)."""
        if given_parameters:
            raise ValueError(
                "warm_start=True cannot be combined with given_parameters: "
                "initialization (which warm start skips) is what stitches "
                "given values into the model state. Freeze parameters on a "
                "cold fit instead."
            )
        asignatures = getattr(self, "asignatures", None)
        exposures = None
        try:
            exposures = self.adata.obsm["exposures"]
        except (AttributeError, KeyError):
            pass
        if asignatures is None or exposures is None:
            raise ValueError(
                "warm_start=True resumes from the state already in the "
                "model and container (signatures + exposures/scalings/"
                "embeddings); fit once without warm_start - or load a "
                "saved model (io.load_model) - first."
            )
        if (asignatures.n_obs != self.n_signatures
                or asignatures.n_vars != self.adata.n_vars
                or np.shape(exposures) != (self.adata.n_obs,
                                           self.n_signatures)):
            raise ValueError(
                "warm_start=True found state of the wrong shape: expected "
                f"signatures ({self.n_signatures}, {self.adata.n_vars}) "
                f"and exposures ({self.adata.n_obs}, {self.n_signatures}); "
                f"got signatures {asignatures.shape} and exposures "
                f"{np.shape(exposures)}."
            )

    def fit(
        self,
        adata,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        fitting_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        verbose: Literal[0, 1] = 0,
        verbosity_freq: int = 1000,
        stop_on_nonfinite: bool = False,
        mesh=None,
        warm_start: bool = False,
    ) -> "SignatureNMF":
        """Fit all model parameters with the on-device engine.

        Arguments as in the reference fit (signature_nmf.py:315-385):
        given_parameters holds a-priori known parameters to freeze,
        init_kwargs feeds the initializer (e.g. seed), fitting_kwargs feeds
        _setup_fitting_parameters (e.g. KLNMF loss weights).
        stop_on_nonfinite additionally fails fast if the objective becomes
        NaN/Inf (off by default for reference trace parity).

        mesh (optional): a jax.sharding.Mesh with a 'samples' axis
        (parallel.make_mesh); THIS single fit then shards the sample axis
        of X and the per-sample parameters across devices, with XLA
        inserting the cross-device reductions. Same numerics as unsharded
        (pinned in tests); use for cohorts too large for one device.

        warm_start=True skips initialization and CONTINUES from the state
        already in the model/container (a previous fit on the same
        container, or one restored via io.load_model + its container) -
        the manual checkpoint/resume path for long single fits; the
        convergence rule restarts fresh (min_iterations applies again,
        and MvNMF's line-search gamma resets to 1). Beyond the reference
        surface (its fit always re-initializes).
        """
        self._setup_adata(adata)
        if warm_start:
            self._check_warm_start(given_parameters)
        else:
            self._initialize(given_parameters, init_kwargs)
        self._setup_fitting_parameters(fitting_kwargs)

        if getattr(self, "_fits_on_host", False):
            if mesh is not None:
                raise ValueError(
                    "mesh= is not available in host-loop compatibility "
                    "modes (newton_cg_compat): the fit runs host-side."
                )
            return self._fit_host(
                given_parameters, history, verbose, verbosity_freq
            )

        params0, data = self._device_state()
        if mesh is not None:
            params0, data = self._shard_state(params0, data, mesh)
        update_fn, objective_fn = self._build_step(given_parameters)
        objective_fn = promote_objective(objective_fn, params0)
        config = self._fit_config()
        if stop_on_nonfinite:
            config = config._replace(stop_on_nonfinite=True)
        from ..engine.fit import backend_supports_callbacks, print_history_trace

        import jax

        # the tolerance the engine will actually enforce (floored at the
        # objective/parameter dtype resolution) - recorded so the
        # convergence contract is auditable post-fit, not warning-only
        from ..engine import effective_tolerance

        objective_dtype = jax.eval_shape(objective_fn, params0, data).dtype
        self.history["tol_effective"] = effective_tolerance(
            config, objective_dtype, params0
        )

        live_verbose = bool(verbose) and backend_supports_callbacks()
        progress_cb = (
            segment_progress_printer() if verbose and not live_verbose
            else None
        )
        run = cached_fit_runner(
            self, update_fn, objective_fn, config, live_verbose,
            verbosity_freq, given_parameters, objective_dtype,
            self._unroll_blocks, progress_cb,
        )
        result = run(params0, data)
        # one batched device->host transfer for the whole result
        # (engine/transfer.py)
        result = fetch_pytree(result)
        self._absorb_params(result.params)

        if verbose and not live_verbose:
            # backends without host callbacks: print the trace post-fit
            print_history_trace(
                result.history, int(result.n_evals),
                self.conv_test_freq, verbosity_freq,
            )
        if history:
            n_evals = int(result.n_evals)
            self.history["objective_function"] = list(
                np.asarray(result.history)[:n_evals]
            )
            self.history["n_iterations"] = int(result.n_iterations)
            self.history["step_freq"] = self.conv_test_freq
        self._is_fitted = True
        return self

    def _fit_host(self, given_parameters=None, history: bool = True,
                  verbose: int = 0, verbosity_freq: int = 1000,
                  ) -> "SignatureNMF":
        """Reference-verbatim host fit loop (used by compatibility modes
        whose per-iteration updates run host-side, e.g. CorrNMF's
        newton_cg_compat). Semantics: reference signature_nmf.py:315-385."""
        # host loops run float64 numpy throughout: the user's tol is enforced
        self.history["tol_effective"] = float(self.tol)
        of_values = [self.objective_function()]
        n_iteration = 0
        converged = False
        while not converged:
            n_iteration += 1
            if verbose and n_iteration % verbosity_freq == 0:
                print(f"iteration: {n_iteration}; "
                      f"objective: {of_values[-1]:.2f}")
            self._update_parameters(given_parameters)
            if n_iteration % self.conv_test_freq == 0:
                previous = of_values[-1]
                of_values.append(self.objective_function())
                rel_change = abs(previous - of_values[-1]) / abs(previous)
                converged = (
                    rel_change < self.tol
                    and n_iteration >= self.min_iterations
                )
            converged |= n_iteration >= self.max_iterations
        if history:
            self.history["objective_function"] = of_values[1:]
            self.history["n_iterations"] = n_iteration
            self.history["step_freq"] = self.conv_test_freq
        self._is_fitted = True
        return self

    # ------------------------------------------------------------------ #
    # analysis
    # ------------------------------------------------------------------ #
    def reorder(self, asignatures_other, metric: str = "cosine",
                keep_names: bool = False) -> None:
        """Permute this model's signatures to best match another collection
        (Hungarian assignment on pairwise distances)."""
        names = self.asignatures.obs_names
        order = match_signatures_pair(
            asignatures_other.to_df(), self.asignatures.to_df(), metric=metric
        )
        self.asignatures = self.asignatures[order, :].copy()
        self.adata.obsm["exposures"] = self.adata.obsm["exposures"][:, order]
        if not keep_names:
            self.asignatures.obs_names = names

    def compute_correlation(
        self, data: Literal["samples", "signatures"] = "signatures", **kwargs
    ) -> None:
        value_checker("data", data, ["samples", "signatures"])
        assert "exposures" in self.adata.obsm, (
            "Computing the sample or signature correlation "
            "requires fitting the NMF model."
        )
        values = self.adata.obsm["exposures"]
        if data == "signatures":
            values = values.T
        corr = tl.correlation_numpy(values, **kwargs)
        if data == "samples":
            self.adata.obsp["X_correlation"] = corr
        else:
            self.asignatures.obsp["correlation"] = corr

    def correlation(
        self, data: Literal["samples", "signatures"] = "signatures"
    ) -> pd.DataFrame:
        value_checker("data", data, ["samples", "signatures"])
        if data == "samples":
            if "X_correlation" not in self.adata.obsp:
                self.compute_correlation("samples")
            values, names = self.adata.obsp["X_correlation"], self.sample_names
        else:
            if "correlation" not in self.asignatures.obsp:
                self.compute_correlation("signatures")
            values, names = self.asignatures.obsp["correlation"], self.signature_names
        return pd.DataFrame(values, index=names, columns=names)

    # ------------------------------------------------------------------ #
    # plotting wrappers (host-side; implementations in salamander_tpu.plot)
    # ------------------------------------------------------------------ #
    def plot_history(self, outfile: str | None = None, **kwargs):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        assert "objective_function" in self.history, (
            "No history available, the model has to be fitted first. "
            "Remember to set 'history' to 'True' when calling 'fit()'."
        )
        if len(self.history["objective_function"]) == 0:
            raise ValueError(
                "The objective trace is empty: fit_minibatch(eval_freq=0) "
                "records no objective values. Refit with eval_freq >= 1 to "
                "plot a history."
            )
        ax = pl.history(
            values=self.history["objective_function"],
            # fit_minibatch traces are spaced by eval_freq, not conv_test_freq
            conv_test_freq=self.history.get("step_freq", self.conv_test_freq),
            **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax

    def plot_signatures(self, annotate_mutation_types: bool = False,
                        outfile: str | None = None, **kwargs):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        axes = pl.barplot(
            self.asignatures, annotate_vars=annotate_mutation_types, **kwargs
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return axes

    def plot_exposures(
        self,
        sample_order: np.ndarray | None = None,
        reorder_signatures: bool = True,
        annotate_samples: bool = True,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        ax = pl.stacked_barplot(
            data=self.exposures,
            obs_order=sample_order,
            reorder_dimensions=reorder_signatures,
            annotate_obs=annotate_samples,
            **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax

    def plot_correlation(
        self,
        data: Literal["samples", "signatures"] = "signatures",
        annot: bool | None = None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        value_checker("data", data, ["samples", "signatures"])
        corr = self.correlation(data=data)
        if annot is None:
            annot = data != "samples"
        clustergrid = pl.correlation_pandas(corr, annot=annot, **kwargs)
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return clustergrid

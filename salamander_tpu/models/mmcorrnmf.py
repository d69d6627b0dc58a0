"""Multimodal correlated NMF: several CorrNMF models fitted jointly with
shared sample embeddings.

API parity with the reference MultimodalCorrNMF (models/mmcorrnmf.py:35-739):
a standalone class (not a SignatureNMF subclass) over a MuData of modalities
sharing sample names; per-modality signatures/scalings/signature-embeddings;
ONE shared set of sample embeddings and ONE shared variance; ELBO sums the
per-modality terms with the sample penalty added once (:168-194); the joint
sample-embedding M-step concatenates signature embeddings, scalings and aux
across modalities (:398-428).

Device realization: modalities are ragged in (n_features, n_signatures),
so the parameter pytree nests a dict of per-modality arrays; the update cycle
unrolls over modalities at trace time (n_mod is small) and the joint sample
update is a single vmap-batched Newton solve over the concatenated signature
axis, inside the same jitted convergence engine as every other model.
"""

from __future__ import annotations

import warnings
from typing import Any, Iterable, Literal

import jax.numpy as jnp
import numpy as np
import pandas as pd

from .. import containers, tools as tl
from ..engine import FitConfig
from ..engine.transfer import fetch_pytree
from ..initialization.initialize import EPSILON, initialize_mmcorrnmf
from ..ops import corrnmf as ops
from ..ops import klnmf as klnmf_ops
from ..utils import (
    compute_exposures_numpy, dict_checker, type_checker, value_checker,
)
from .corrnmf_det import SAMPLE_NEWTON_ITERS, SIGNATURE_NEWTON_ITERS
from .signature_nmf import SignatureNMF
from .signature_nmf import promote_objective, resolve_dtype


class MultimodalCorrNMF:
    """Joint correlated NMF over multiple count modalities of the same
    samples, with shared sample embeddings and variance."""

    def __init__(
        self,
        ns_signatures: list[int],
        dim_embeddings: int | None = None,
        init_method: str = "nndsvd",
        min_iterations: int = 500,
        max_iterations: int = 10000,
        conv_test_freq: int = 10,
        tol: float = 1e-7,
        dtype: str | None = None,
        newton_cg_compat: bool = False,
    ):
        self.ns_signatures = list(ns_signatures)
        # opt-in auditing mode (see CorrNMF.newton_cg_compat)
        self.newton_cg_compat = newton_cg_compat
        self.dim_embeddings = (
            int(np.max(ns_signatures)) if dim_embeddings is None else dim_embeddings
        )
        self.init_method = init_method
        self.min_iterations = min_iterations
        self.max_iterations = max_iterations
        self.conv_test_freq = conv_test_freq
        self.tol = tol
        resolved = resolve_dtype(dtype)
        self.dtype = None if resolved is None else resolved.name
        self.variance = 1.0

        default_names = [f"mod{n}" for n in range(1, len(ns_signatures) + 1)]
        self.mdata = containers.MuData(
            {name: containers.AnnData() for name in default_names}
        )
        self.asignatures = {
            name: containers.AnnData() for name in default_names
        }
        self.history: dict[str, Any] = {}
        self._is_fitted = False
        total = sum(ns_signatures)
        self.signature_correlation = np.full((total, total), np.nan)

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    @property
    def mod_names(self) -> list[str]:
        return list(self.mdata.mod.keys())

    @property
    def mutation_types(self) -> dict[str, list[str]]:
        return {
            name: list(adata.var_names) for name, adata in self.mdata.mod.items()
        }

    @property
    def signature_names(self) -> dict[str, list[str]]:
        return {
            name: list(asigs.obs_names) for name, asigs in self.asignatures.items()
        }

    @property
    def sample_names(self) -> list[str]:
        return list(self.mdata.obs_names)

    @property
    def signatures(self) -> dict[str, pd.DataFrame]:
        return {name: asigs.to_df() for name, asigs in self.asignatures.items()}

    @property
    def exposures(self) -> dict[str, pd.DataFrame]:
        return {
            name: pd.DataFrame(
                self.mdata[name].obsm["exposures"],
                index=self.sample_names,
                columns=self.asignatures[name].obs_names,
            )
            for name in self.mod_names
        }

    def compute_exposures(self) -> None:
        # host-side: inputs are host arrays, and an eager device call would
        # round-trip them through the accelerator (see utils twin)
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            adata.obsm["exposures"] = compute_exposures_numpy(
                asigs.obs["scalings"],
                adata.obs["scalings"],
                asigs.obsm["embeddings"],
                self.mdata.obsm["embeddings"],
            )

    def compute_reconstruction(self) -> None:
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            adata.obsm["X_reconstructed"] = adata.obsm["exposures"] @ asigs.X

    @property
    def data_reconstructed(self) -> dict[str, pd.DataFrame]:
        if any(
            "X_reconstructed" not in adata.obsm
            for adata in self.mdata.mod.values()
        ):
            self.compute_reconstruction()
        return {
            name: pd.DataFrame(
                adata.obsm["X_reconstructed"],
                index=adata.obs_names,
                columns=adata.var_names,
            )
            for name, adata in self.mdata.mod.items()
        }

    def compute_reconstruction_errors(self) -> None:
        self.compute_exposures()
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            errors = klnmf_ops.samplewise_kl_divergence(
                adata.X.T, asigs.X.T, adata.obsm["exposures"].T
            )
            adata.obs["reconstruction_error"] = np.asarray(errors)
        self.mdata.update()

    @property
    def reconstruction_errors(self) -> dict[str, float]:
        if any(
            "reconstruction_error" not in self.mdata[name].obs
            for name in self.mod_names
        ):
            self.compute_reconstruction_errors()
        return {
            name: float(np.sum(adata.obs["reconstruction_error"]))
            for name, adata in self.mdata.mod.items()
        }

    @property
    def reconstruction_error(self) -> float:
        return float(np.sum(list(self.reconstruction_errors.values())))

    # ------------------------------------------------------------------ #
    # objective
    # ------------------------------------------------------------------ #
    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "maximize"

    def objective_function(self) -> float:
        elbo = 0.0
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            elbo += float(
                ops.elbo_corrnmf(
                    adata.X,
                    asigs.X,
                    adata.obsm["exposures"],
                    asigs.obsm["embeddings"],
                    self.mdata.obsm["embeddings"],
                    self.variance,
                    penalize_sample_embeddings=False,
                )
            )
        n_obs = self.mdata.n_obs
        elbo -= (
            0.5 * self.dim_embeddings * n_obs
            * np.log(2 * np.pi * self.variance)
        )
        elbo -= float(
            np.sum(self.mdata.obsm["embeddings"] ** 2) / (2 * self.variance)
        )
        return elbo

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #
    def _setup_mdata(self, mdata) -> None:
        if not hasattr(mdata, "mod"):
            type_checker("mdata", mdata, containers.MuData)
        if mdata.n_mod != len(self.ns_signatures):
            raise ValueError(
                f"The data has to have {len(self.ns_signatures)} many modalities."
            )
        expected = list(list(mdata.mod.values())[0].obs_names)
        for adata in mdata.mod.values():
            if list(adata.obs_names) != expected:
                raise ValueError(
                    "The sample names of the different modalities are not identical."
                )
        for adata in mdata.mod.values():
            SignatureNMF._invalidate_derived(adata)
            adata.X = adata.X.clip(EPSILON)
        self.mdata = mdata

    def _setup_mdata_streaming(self, mdata) -> None:
        """_setup_mdata for the host-streaming fit: integer-dtype modality
        count matrices stay UNCLIPPED in place (clipping would promote
        compact integer storage to float64 at beyond-HBM scale; the clip is
        applied per uploaded batch instead - see
        SignatureNMF._setup_adata_streaming)."""
        if not hasattr(mdata, "mod"):
            type_checker("mdata", mdata, containers.MuData)
        if mdata.n_mod != len(self.ns_signatures):
            raise ValueError(
                f"The data has to have {len(self.ns_signatures)} many modalities."
            )
        expected = list(list(mdata.mod.values())[0].obs_names)
        for adata in mdata.mod.values():
            if list(adata.obs_names) != expected:
                raise ValueError(
                    "The sample names of the different modalities are not identical."
                )
        for adata in mdata.mod.values():
            SignatureNMF._invalidate_derived(adata)
            # dtype without materializing (lazily-backed X stays on disk)
            x_dtype = getattr(adata.X, "dtype", None)
            if x_dtype is None:
                x_dtype = np.asarray(adata.X).dtype
            if not np.issubdtype(x_dtype, np.integer):
                adata.X = adata.X.clip(EPSILON)
        self.mdata = mdata

    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        init_kwargs = {} if init_kwargs is None else init_kwargs.copy()
        self.asignatures, self.variance = initialize_mmcorrnmf(
            self.mdata,
            self.ns_signatures,
            self.dim_embeddings,
            self.init_method,
            given_parameters,
            **init_kwargs,
        )
        self.compute_exposures()

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        dtype = resolve_dtype(self.dtype)
        data = {
            "X": {
                name: jnp.asarray(self.mdata[name].X, dtype)
                for name in self.mod_names
            }
        }
        return self._device_params(), data

    def _device_params(self, include_exposures: bool = True):
        """The parameter pytree alone - no count-matrix uploads (the
        streaming fit path's entry; see fit_minibatch)."""
        dtype = resolve_dtype(self.dtype)
        mods = {}
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            mods[name] = {
                "signatures": jnp.asarray(asigs.X, dtype),
                "signature_scalings": jnp.asarray(
                    np.asarray(asigs.obs["scalings"], dtype=float), dtype
                ),
                "sample_scalings": jnp.asarray(
                    np.asarray(adata.obs["scalings"], dtype=float), dtype
                ),
                "signature_embeddings": jnp.asarray(
                    asigs.obsm["embeddings"], dtype
                ),
            }
            if include_exposures:
                mods[name]["exposures"] = jnp.asarray(
                    adata.obsm["exposures"], dtype
                )
        return {
            "mods": mods,
            "sample_embeddings": jnp.asarray(self.mdata.obsm["embeddings"], dtype),
            "variance": jnp.asarray(float(self.variance), dtype),
        }

    def _absorb_params(self, params) -> None:
        for name in self.mod_names:
            mod = params["mods"][name]
            adata, asigs = self.mdata[name], self.asignatures[name]
            asigs.X = np.asarray(mod["signatures"])
            asigs.obs["scalings"] = np.asarray(mod["signature_scalings"])
            adata.obs["scalings"] = np.asarray(mod["sample_scalings"])
            asigs.obsm["embeddings"] = np.asarray(mod["signature_embeddings"])
            adata.obsm["exposures"] = np.asarray(mod["exposures"])
        self.mdata.obsm["embeddings"] = np.asarray(params["sample_embeddings"])
        self.variance = float(params["variance"])

    def _mod_flags(self, given_parameters) -> dict:
        """Per-modality freeze flags derived from a nested given_parameters
        dict — the single source of truth for which modality parameters fit
        and fit_minibatch hold fixed."""
        given = given_parameters or {}
        flags = {}
        for index, name in enumerate(self.mod_names):
            g = given.get(name, {})
            n_given = g["asignatures"].n_obs if "asignatures" in g else 0
            flags[name] = {
                "n_given": int(n_given),
                "fix_signatures": n_given == self.ns_signatures[index],
                "fix_sig_scalings": "signature_scalings" in g,
                "fix_smp_scalings": "sample_scalings" in g,
                "fix_sig_embeddings": "signature_embeddings" in g,
            }
        return flags

    def _check_warm_start(self, given_parameters) -> None:
        """Validate resumable multimodal state (warm_start=True)."""
        if given_parameters:
            raise ValueError(
                "warm_start=True cannot be combined with given_parameters: "
                "initialization (which warm start skips) is what stitches "
                "given values into the model state."
            )
        try:
            for name in self.mod_names:
                asigs = self.asignatures[name]
                np.asarray(asigs.obs["scalings"])
                np.asarray(asigs.obsm["embeddings"])
                np.asarray(self.mdata[name].obsm["exposures"])
                np.asarray(self.mdata[name].obs["scalings"])
            np.asarray(self.mdata.obsm["embeddings"])
            float(self.variance)
        except (AttributeError, KeyError, TypeError):
            raise ValueError(
                "warm_start=True resumes from the state already in the "
                "model and containers (per-modality signatures/scalings/"
                "exposures + shared embeddings/variance); fit once without "
                "warm_start - or load a saved model - first."
            ) from None

    def _step_cache_key(self, given_parameters=None):
        # everything _build_step bakes: modality layout, embedding dim and
        # the per-modality freeze flags (given VALUES ride in params)
        given = given_parameters or {}
        flags = self._mod_flags(given_parameters)
        return (
            "mmcorrnmf",
            tuple(self.mod_names),
            tuple(int(n) for n in self.ns_signatures),
            int(self.dim_embeddings),
            tuple(
                (name, tuple(sorted(mod_flags.items())))
                for name, mod_flags in flags.items()
            ),
            "sample_embeddings" in given,
            "variance" in given,
        )

    def _build_step(self, given_parameters=None):
        given = given_parameters or {}
        mod_names = self.mod_names
        ns_signatures = self.ns_signatures
        flags = self._mod_flags(given_parameters)
        fix_sample_embeddings = "sample_embeddings" in given
        fix_variance = "variance" in given
        dim = self.dim_embeddings

        def update_fn(params, data):
            mods = {name: dict(params["mods"][name]) for name in mod_names}
            U = params["sample_embeddings"]
            variance = params["variance"]

            # 1+2: per-modality sample scalings, then exposures
            for name in mod_names:
                m, f = mods[name], flags[name]
                if not f["fix_smp_scalings"]:
                    m["sample_scalings"] = ops.update_sample_scalings(
                        data["X"][name],
                        m["signature_scalings"],
                        m["signature_embeddings"],
                        U,
                    )
                m["exposures"] = ops.compute_exposures(
                    m["signature_scalings"], m["sample_scalings"],
                    m["signature_embeddings"], U,
                )

            # 3: per-modality sufficient statistics
            auxs = {
                name: ops.compute_aux(
                    data["X"][name], mods[name]["signatures"],
                    mods[name]["exposures"],
                )
                for name in mod_names
            }

            # 4: signature scalings
            for name in mod_names:
                m, f = mods[name], flags[name]
                if not f["fix_sig_scalings"]:
                    m["signature_scalings"] = ops.update_signature_scalings(
                        auxs[name], m["sample_scalings"],
                        m["signature_embeddings"], U,
                    )

            # 5a: per-modality signature embeddings (vs shared samples)
            for name in mod_names:
                m, f = mods[name], flags[name]
                if not f["fix_sig_embeddings"]:
                    m["signature_embeddings"] = ops.update_embeddings(
                        m["signature_embeddings"], U,
                        m["signature_scalings"], m["sample_scalings"],
                        variance, auxs[name],
                        max_iter=SIGNATURE_NEWTON_ITERS,
                    )

            # 5b: joint sample embeddings across modalities
            if not fix_sample_embeddings:
                sig_embs = jnp.concatenate(
                    [mods[n]["signature_embeddings"] for n in mod_names], axis=0
                )
                sig_scals = jnp.concatenate(
                    [mods[n]["signature_scalings"] for n in mod_names]
                )
                aux_all = jnp.concatenate(
                    [auxs[n] for n in mod_names], axis=0
                )  # (sum K, D)
                # per-sample scalings repeated per modality signature count
                scalings_mat = jnp.concatenate(
                    [
                        jnp.tile(
                            mods[n]["sample_scalings"][:, None],
                            (1, ns_signatures[i]),
                        )
                        for i, n in enumerate(mod_names)
                    ],
                    axis=1,
                )  # (D, sum K)
                U = ops.update_embeddings(
                    U, sig_embs, scalings_mat, sig_scals, variance, aux_all.T,
                    max_iter=SAMPLE_NEWTON_ITERS,
                )

            # 6: shared variance over all embeddings
            if not fix_variance:
                all_sig_embs = jnp.concatenate(
                    [mods[n]["signature_embeddings"] for n in mod_names], axis=0
                )
                variance = ops.update_variance(all_sig_embs, U)

            # 7: signatures via KL multiplicative update (step-2 exposures)
            for name in mod_names:
                m, f = mods[name], flags[name]
                if not f["fix_signatures"]:
                    W = klnmf_ops.update_W(
                        data["X"][name].T,
                        m["signatures"].T,
                        m["exposures"].T,
                        n_given_signatures=f["n_given"],
                    )
                    m["signatures"] = W.T

            return {
                "mods": mods,
                "sample_embeddings": U,
                "variance": variance,
            }

        def objective_fn(params, data):
            U = params["sample_embeddings"]
            variance = params["variance"]
            elbo = 0.0
            for name in mod_names:
                m = params["mods"][name]
                elbo += ops.elbo_corrnmf(
                    data["X"][name], m["signatures"], m["exposures"],
                    m["signature_embeddings"], U, variance,
                    penalize_sample_embeddings=False,
                )
            n_obs = U.shape[0]
            elbo -= 0.5 * dim * n_obs * jnp.log(2 * jnp.pi * variance)
            elbo -= jnp.sum(U**2) / (2 * variance)
            return elbo

        return update_fn, objective_fn

    def _update_parameters(self, given_parameters=None) -> None:
        """One full joint EM cycle, eagerly (test/inspection surface)."""
        if self.newton_cg_compat:
            self._update_parameters_host(given_parameters)
            return
        params, data = self._device_state()
        update_fn, _ = self._build_step(given_parameters)
        self._absorb_params(update_fn(params, data))

    def _update_parameters_host(self, given_parameters=None) -> None:
        """One full joint EM cycle through the eager reference-named methods
        (the compatibility path: exact reference order, scipy Newton-CG
        embeddings; reference mmcorrnmf.py:443-453)."""
        given = given_parameters or {}
        self.update_sample_scalings(given)
        self.compute_exposures()
        auxs = self._compute_auxs()
        self.update_signature_scalings(auxs, given)
        self.update_embeddings(auxs, given)
        self.update_variance(given)
        self.update_signatures(given)

    # ------------------------------------------------------------------ #
    # eager per-update methods (reference-named test/inspection surface)
    # ------------------------------------------------------------------ #
    def _compute_auxs(self) -> dict[str, np.ndarray]:
        return {
            name: np.asarray(
                ops.compute_aux(
                    self.mdata[name].X,
                    self.asignatures[name].X,
                    self.mdata[name].obsm["exposures"],
                )
            )
            for name in self.mod_names
        }

    def update_sample_scalings_mod(
        self, mod_name: str, given_parameters_mod: dict[str, Any]
    ) -> None:
        """One modality's sample-scaling M-step (reference-named eager
        surface, mmcorrnmf.py:249-261)."""
        if "sample_scalings" in given_parameters_mod:
            return
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        adata.obs["scalings"] = np.asarray(
            ops.update_sample_scalings(
                adata.X,
                np.asarray(asigs.obs["scalings"]),
                asigs.obsm["embeddings"],
                self.mdata.obsm["embeddings"],
            )
        )

    def update_sample_scalings(self, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_sample_scalings_mod(name, given.get(name, {}))

    def update_signature_scalings_mod(
        self, mod_name: str, aux, given_parameters_mod: dict[str, Any]
    ) -> None:
        """One modality's signature-scaling M-step (reference
        mmcorrnmf.py:276-287)."""
        if "signature_scalings" in given_parameters_mod:
            return
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        asigs.obs["scalings"] = np.asarray(
            ops.update_signature_scalings(
                aux,
                np.asarray(adata.obs["scalings"]),
                asigs.obsm["embeddings"],
                self.mdata.obsm["embeddings"],
            )
        )

    def update_signature_scalings(self, auxs, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_signature_scalings_mod(
                name, auxs[name], given.get(name, {})
            )

    def update_signature_embeddings_mod(
        self,
        mod_name: str,
        aux,
        outer_prods_sample_embeddings=None,
        given_parameters_mod: dict[str, Any] | None = None,
    ) -> None:
        """One modality's signature-embedding M-step (reference
        mmcorrnmf.py:347-366). `outer_prods_sample_embeddings` is accepted
        for signature parity but unused: the reference precomputes the
        scipy Hessian's outer products, while the batched device Newton
        (and the compat scipy path) derive everything they need from the
        other arguments."""
        del outer_prods_sample_embeddings
        if "signature_embeddings" in (given_parameters_mod or {}):
            return
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        if self.newton_cg_compat:
            asigs.obsm["embeddings"] = ops.update_embeddings_newton_cg(
                asigs.obsm["embeddings"],
                self.mdata.obsm["embeddings"],
                np.asarray(asigs.obs["scalings"]),
                np.asarray(adata.obs["scalings"]),
                self.variance,
                aux,
                max_iter=None,
            )
            return
        asigs.obsm["embeddings"] = np.asarray(
            ops.update_embeddings(
                asigs.obsm["embeddings"],
                self.mdata.obsm["embeddings"],
                np.asarray(asigs.obs["scalings"]),
                np.asarray(adata.obs["scalings"]),
                self.variance,
                aux,
                max_iter=SIGNATURE_NEWTON_ITERS,
            )
        )

    def update_signature_embeddings(self, auxs, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_signature_embeddings_mod(
                name, auxs[name], None, given.get(name, {})
            )

    def update_sample_embeddings(self, auxs) -> None:
        sig_embs = np.concatenate(
            [asigs.obsm["embeddings"] for asigs in self.asignatures.values()]
        )
        sig_scals = np.concatenate(
            [np.asarray(asigs.obs["scalings"]) for asigs in self.asignatures.values()]
        )
        aux_all = np.concatenate([auxs[name] for name in self.mod_names])
        scalings_mat = np.concatenate(
            [
                np.tile(
                    np.asarray(self.mdata[name].obs["scalings"])[:, None],
                    (1, k),
                )
                for name, k in zip(self.mod_names, self.ns_signatures)
            ],
            axis=1,
        )
        if self.newton_cg_compat:
            self.mdata.obsm["embeddings"] = ops.update_embeddings_newton_cg(
                self.mdata.obsm["embeddings"],
                sig_embs,
                scalings_mat,
                sig_scals,
                self.variance,
                aux_all.T,
                max_iter=SAMPLE_NEWTON_ITERS,
            )
            return
        self.mdata.obsm["embeddings"] = np.asarray(
            ops.update_embeddings(
                self.mdata.obsm["embeddings"],
                sig_embs,
                scalings_mat,
                sig_scals,
                self.variance,
                aux_all.T,
                max_iter=SAMPLE_NEWTON_ITERS,
            )
        )

    def update_embeddings(self, auxs, given_parameters=None) -> None:
        given = given_parameters or {}
        self.update_signature_embeddings(auxs, given)
        if "sample_embeddings" not in given:
            self.update_sample_embeddings(auxs)

    def update_variance(self, given_parameters=None) -> None:
        given = given_parameters or {}
        if "variance" not in given:
            sig_embs = np.concatenate(
                [asigs.obsm["embeddings"] for asigs in self.asignatures.values()]
            )
            self.variance = float(
                ops.update_variance(sig_embs, self.mdata.obsm["embeddings"])
            )

    def update_signatures_mod(
        self, mod_name: str, given_parameters_mod: dict[str, Any]
    ) -> None:
        """One modality's KL signature update (reference
        mmcorrnmf.py:319-334)."""
        n_given = (
            given_parameters_mod["asignatures"].n_obs
            if "asignatures" in given_parameters_mod
            else 0
        )
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        W = klnmf_ops.update_W(
            adata.X.T,
            asigs.X.T,
            adata.obsm["exposures"].T,
            n_given_signatures=n_given,
        )
        asigs.X = np.asarray(W).T

    def update_signatures(self, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_signatures_mod(name, given.get(name, {}))

    # ------------------------------------------------------------------ #
    # fit
    # ------------------------------------------------------------------ #
    def _fit_config(self) -> FitConfig:
        return FitConfig(
            min_iterations=self.min_iterations,
            max_iterations=self.max_iterations,
            conv_test_freq=self.conv_test_freq,
            tol=self.tol,
        )

    # ------------------------------------------------------------------ #
    # sample-axis sharding
    # ------------------------------------------------------------------ #
    # leaves whose leading axis is the (shared) sample axis D; everything
    # else in the state is signature-side and replicates. The joint
    # sample-embedding Newton solve (reference mmcorrnmf.py:398-428) is
    # sample-local, so only the signature-side aux reductions all-reduce.
    _SAMPLE_LEAVES = frozenset(
        {"sample_scalings", "sample_embeddings", "exposures", "sample_usq"}
    )

    def _shard_state(self, params, data, mesh):
        """device_put the multimodal fit state under `mesh`.

        X of every modality and the per-sample parameters (shared sample
        embeddings, per-modality sample scalings/exposures) shard their
        sample axis; signature-side leaves replicate. Numerics unchanged -
        sharded == unsharded pinned in tests/test_sharding.py.
        """
        import jax
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.mesh import SAMPLE_AXIS

        if SAMPLE_AXIS not in mesh.axis_names:
            raise ValueError(
                f"mesh has axes {mesh.axis_names}; fit expects a "
                f"'{SAMPLE_AXIS}' axis (parallel.make_mesh(sample_ways=...))."
            )
        samples_first = NamedSharding(mesh, PartitionSpec(SAMPLE_AXIS))
        replicated = NamedSharding(mesh, PartitionSpec())

        def put(tree, force_samples=False):
            out = {}
            for key, leaf in tree.items():
                if isinstance(leaf, dict):
                    # data['X'] nests per-modality (D, V) count matrices
                    out[key] = put(leaf, force_samples=(key == "X"))
                    continue
                sharded = force_samples or key in self._SAMPLE_LEAVES
                out[key] = jax.device_put(
                    jnp.asarray(leaf),
                    samples_first if sharded else replicated,
                )
            return out

        return put(params), put(data)

    def fit(
        self,
        mdata,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        verbose: Literal[0, 1] = 0,
        verbosity_freq: int = 100,
        stop_on_nonfinite: bool = False,
        mesh=None,
        warm_start: bool = False,
    ) -> "MultimodalCorrNMF":
        """Fit the joint model (reference fit loop: mmcorrnmf.py:455-491).

        mesh (optional): a jax.sharding.Mesh with a 'samples' axis; the
        shared sample axis of every modality's counts and the per-sample
        parameters then shard across devices (see _shard_state).

        warm_start=True skips initialization and CONTINUES from the state
        already in the model/containers (the manual checkpoint/resume
        path: io.save_model / load_model round-trips it); the convergence
        rule restarts fresh.
        """
        self._setup_mdata(mdata)
        if warm_start:
            self._check_warm_start(given_parameters)
        else:
            self._initialize(given_parameters, init_kwargs)

        if self.newton_cg_compat:
            if mesh is not None:
                raise ValueError(
                    "mesh= is not available under newton_cg_compat=True: "
                    "the scipy-exact fit loop runs host-side."
                )
            # reference-verbatim host loop over the scipy-exact update cycle
            of_values = [self.objective_function()]
            n_iteration = 0
            converged = False
            while not converged:
                n_iteration += 1
                if verbose and n_iteration % verbosity_freq == 0:
                    print(f"iteration: {n_iteration}; "
                          f"objective: {of_values[-1]:.2f}")
                self._update_parameters_host(given_parameters)
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
            self.mdata.update()
            self._is_fitted = True
            return self

        params0, data = self._device_state()
        if mesh is not None:
            params0, data = self._shard_state(params0, data, mesh)
        update_fn, objective_fn = self._build_step(given_parameters)
        objective_fn = promote_objective(objective_fn, params0)
        config = self._fit_config()
        if stop_on_nonfinite:
            config = config._replace(stop_on_nonfinite=True)
        from ..engine.fit import backend_supports_callbacks, print_history_trace
        from .signature_nmf import cached_fit_runner, segment_progress_printer

        import jax

        objective_dtype = jax.eval_shape(objective_fn, params0, data).dtype
        live_verbose = bool(verbose) and backend_supports_callbacks()
        progress_cb = (
            segment_progress_printer() if verbose and not live_verbose
            else None
        )
        run = cached_fit_runner(
            self, update_fn, objective_fn, config, live_verbose,
            verbosity_freq, given_parameters, objective_dtype,
            False,  # unroll: per-modality EM with nested Newton solves
            progress_cb,
        )
        result = run(params0, data)
        # one batched device->host transfer for the whole result
        result = fetch_pytree(result)
        self._absorb_params(result.params)

        if verbose and not live_verbose:
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
        self.mdata.update()
        self._is_fitted = True
        return self

    def fit_minibatch(
        self,
        mdata,
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
    ) -> "MultimodalCorrNMF":
        """Stochastic (minibatch) variational EM for the multimodal model:
        one shared minibatch of samples drives all modalities per step, with
        the joint sample-embedding solve over the concatenated signature
        axes and Robbins-Monro-averaged per-modality global statistics
        (ops/svi.py). With batch_size >= n_samples (it is clamped), delay=1
        and signature_newton_iters=100, the first step is one full joint EM
        cycle; see CorrNMFDet.fit_minibatch for cost semantics and practical
        guidance (full-batch `fit` is preferred while its O(n_samples)
        cycles are acceptable; eval_freq=0 skips the full-data ELBO
        evaluations). streaming=True keeps every modality's count matrix
        HOST-resident with per-step minibatch uploads - the single-chip
        beyond-HBM path, bitwise-equal to the resident path at the same
        seed (see CorrNMFDet.fit_minibatch / ops/svi.py
        run_svi_streaming). mesh shards the resident path's sample axis
        across devices (X, sample scalings, shared embeddings); the
        streaming path is host-driven single-device and rejects it."""
        from ..ops import svi

        if mesh is not None and streaming:
            raise ValueError(
                "mesh= and streaming=True are mutually exclusive: streaming "
                "keeps the counts host-resident and uploads minibatches to "
                "ONE device. Shard a resident fit, or stream unsharded."
            )
        if self.newton_cg_compat:
            raise ValueError(
                "fit_minibatch does not support newton_cg_compat=True: the "
                "scipy-exact host path has no minibatch twin, so compat-mode "
                "audit traces would silently get device-Newton numerics. "
                "Use fit() for auditable traces."
            )

        if streaming:
            self._setup_mdata_streaming(mdata)
        else:
            self._setup_mdata(mdata)
        self._initialize(given_parameters, init_kwargs)

        given = given_parameters or {}

        n_samples = int(self.mdata.n_obs)
        config = svi.SVIConfig(
            batch_size=min(int(batch_size), n_samples),
            forgetting=forgetting, delay=delay,
            signature_newton_iters=signature_newton_iters,
            sample_newton_iters=SAMPLE_NEWTON_ITERS,
        )
        step_kwargs = dict(
            n_samples=n_samples,
            mod_names=self.mod_names,
            ns_signatures=self.ns_signatures,
            config=config,
            mod_flags=self._mod_flags(given_parameters),
            fix_sample_embeddings="sample_embeddings" in given,
            fix_variance="variance" in given,
        )
        import jax

        if streaming:
            params = self._device_params(include_exposures=False)
            dtype = np.dtype(params["sample_embeddings"].dtype)
            X_host = {name: self.mdata[name].X for name in self.mod_names}
            eps32 = np.finfo(np.float32).eps

            def get_batch(indices):
                return {
                    name: np.asarray(X_host[name][indices], dtype).clip(eps32)
                    for name in self.mod_names
                }

            objective_fn = None
            if eval_freq:
                objective_fn = svi.make_streamed_objective(
                    svi.mm_elbo_stream_chunk, svi.mm_elbo_stream_rest,
                    get_batch, n_samples, chunk_size=eval_chunk,
                )
            state0 = svi.mm_svi_init(params, streaming=True)
            state, elbo_trace = svi.run_svi_streaming(
                svi.make_mm_svi_batch_step(**step_kwargs), state0, get_batch,
                n_samples, config.batch_size, jax.random.PRNGKey(seed),
                n_steps, eval_freq, objective_fn,
                refresh_fn=svi.refresh_sample_usq,
            )
        else:
            params, data = self._device_state()
            if mesh is not None:
                params, data = self._shard_state(params, data, mesh)
            step_fn = svi.make_mm_svi_step(**step_kwargs)
            state0 = svi.mm_svi_init(params)
            state, elbo_trace = svi.run_svi_guarded(
                step_fn, state0, data["X"], jax.random.PRNGKey(seed),
                n_steps, eval_freq, elbo_fn=svi.mm_full_elbo,
                batch_size=config.batch_size, n_samples=n_samples,
            )
        final = {
            "mods": {},
            "sample_embeddings": state.params["sample_embeddings"],
            "variance": state.params["variance"],
        }
        from .corrnmf_det import _exposures_jit as exposures_fn

        for name in self.mod_names:
            mod = dict(state.params["mods"][name])
            mod["exposures"] = exposures_fn(
                mod["signature_scalings"], mod["sample_scalings"],
                mod["signature_embeddings"], final["sample_embeddings"],
            )
            final["mods"][name] = mod
        # one batched device->host transfer for params + trace
        final, elbo_trace = fetch_pytree((final, elbo_trace))
        self._absorb_params(final)
        if history:
            self.history["objective_function"] = list(
                np.asarray(elbo_trace)
            )
            self.history["n_iterations"] = int(n_steps)
            # plot_history x-axis spacing: evals are eval_freq steps apart
            self.history["step_freq"] = int(eval_freq)
        self.mdata.update()
        self._is_fitted = True
        return self

    def transform(self, mdata, **fit_kwargs):
        """Infer sample-side parameters (scalings + shared embeddings) for a
        NEW multimodal cohort under this model's frozen signature-side
        parameters (per-modality signatures, signature scalings and
        signature embeddings, plus the shared variance). Returns the fitted
        projector model; neither `self` nor the input container is modified.

        Mirrors StandardNMF.transform / CorrNMF.transform for the
        multimodal family (the reference expresses this workflow via
        nested given_parameters; this is the one-call convenience)."""
        if not getattr(self, "_is_fitted", False):
            raise ValueError("transform() requires a fitted model.")
        if "given_parameters" in fit_kwargs:
            raise ValueError(
                "transform() freezes this model's signature-side parameters "
                "itself; 'given_parameters' cannot be overridden here - use "
                "fit() directly for custom given parameters."
            )
        from ..io import _HYPERPARAM_KEYS

        # carries dtype and newton_cg_compat into the projector; walk the
        # MRO so user subclasses keep working
        for klass in type(self).__mro__:
            if klass.__name__ in _HYPERPARAM_KEYS:
                hyperparameter_keys = _HYPERPARAM_KEYS[klass.__name__]
                break
        else:
            raise TypeError(
                f"transform() does not know the hyperparameters of "
                f"{type(self).__name__}."
            )
        projector = type(self)(
            **{key: getattr(self, key) for key in hyperparameter_keys}
        )
        from .signature_nmf import share_transform_runner_cache

        share_transform_runner_cache(self, projector)
        given: dict[str, Any] = {"variance": float(self.variance)}
        for name in self.mod_names:
            asigs = self.asignatures[name]
            given[name] = {
                "asignatures": asigs.copy(),
                "signature_scalings": np.asarray(
                    asigs.obs["scalings"], dtype=float
                ),
                "signature_embeddings": np.asarray(asigs.obsm["embeddings"]),
            }
        projector.fit(
            mdata.copy() if hasattr(mdata, "copy") else mdata,
            given_parameters=given,
            **fit_kwargs,
        )
        return projector

    # ------------------------------------------------------------------ #
    # analysis + plotting
    # ------------------------------------------------------------------ #
    def compute_correlation(
        self, data: Literal["samples", "signatures"] = "signatures", **kwargs
    ) -> None:
        value_checker("data", data, ["samples", "signatures"])
        for adata in self.mdata.mod.values():
            assert "exposures" in adata.obsm, (
                "Computing the sample or signature correlation "
                "requires fitting the NMF model."
            )
        values = np.concatenate(
            [adata.obsm["exposures"] for adata in self.mdata.mod.values()], axis=1
        )
        if data == "signatures":
            values = values.T
        corr = tl.correlation_numpy(values, **kwargs)
        if data == "samples":
            self.mdata.obsp["X_correlation"] = corr
        else:
            self.signature_correlation = corr

    def correlation(
        self, data: Literal["samples", "signatures"] = "signatures"
    ) -> pd.DataFrame:
        value_checker("data", data, ["samples", "signatures"])
        if data == "samples":
            if "X_correlation" not in self.mdata.obsp:
                self.compute_correlation("samples")
            values, names = self.mdata.obsp["X_correlation"], self.sample_names
        else:
            if np.isnan(self.signature_correlation).all():
                self.compute_correlation("signatures")
            values = self.signature_correlation
            names = sum(self.signature_names.values(), [])
        return pd.DataFrame(values, index=names, columns=names)

    def plot_history(self, outfile: str | None = None, **kwargs):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        if not self.history:
            raise ValueError(
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

    def plot_signatures(
        self,
        colors=None,
        annotate_mutation_types: bool = False,
        figsize: tuple[float, float] | None = None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        colors = {} if colors is None else colors.copy()
        dict_checker("colors", colors, self.mod_names)
        max_n_signatures = int(np.max(self.ns_signatures))
        if figsize is None:
            figsize = (4 * self.mdata.n_mod, max_n_signatures)
        fig, axes = plt.subplots(max_n_signatures, self.mdata.n_mod,
                                 figsize=figsize, squeeze=False)
        for mod_name, axs in zip(self.mod_names, axes.T):
            sigs = self.asignatures[mod_name]
            pl.barplot(
                sigs,
                colors=colors.get(mod_name),
                annotate_vars=annotate_mutation_types,
                axes=axs[: sigs.n_obs],
                **kwargs,
            )
            for ax in axs[sigs.n_obs:]:
                fig.delaxes(ax)
        plt.tight_layout()
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return axes

    def plot_exposures(
        self,
        sample_order=None,
        reorder_signatures: bool = True,
        annotate_samples: bool = True,
        colors=None,
        axes=None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        if axes is None:
            _, axes = plt.subplots(
                self.mdata.n_mod, figsize=(20, 3 * self.mdata.n_mod)
            )
            axes = np.atleast_1d(axes)
        colors = {} if colors is None else colors.copy()
        dict_checker("colors", colors, self.mod_names)
        exposures = self.exposures

        if sample_order is None:
            normalized = pd.concat(
                [df.div(df.sum(axis=1), axis=0) for df in exposures.values()],
                axis=1,
            )
            sample_order = pl.get_obs_order(normalized)

        for n, (mod_name, ax) in enumerate(zip(self.mod_names, axes)):
            annotate = annotate_samples if n == self.mdata.n_mod - 1 else False
            ax = pl.stacked_barplot(
                data=exposures[mod_name],
                obs_order=sample_order,
                reorder_dimensions=reorder_signatures,
                annotate_obs=annotate,
                colors=colors.get(mod_name),
                ax=ax,
                **kwargs,
            )
            ax.set_title(f"{mod_name} signature exposures")
        plt.tight_layout()
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return axes

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

    def plot_embeddings(
        self,
        method: str = "umap",
        n_components: int = 2,
        dimensions: tuple[int, int] = (0, 1),
        color: str | None = None,
        zorder: str | None = None,
        annotations: Iterable[str] | None = None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        adatas = list(self.asignatures.values()) + [self.mdata]
        tl.reduce_dimension_multiple(
            adatas=adatas, basis="embeddings", method=method,
            n_components=n_components,
        )
        if self.dim_embeddings <= 2:
            warnings.warn(
                f"The embedding dimension is {self.dim_embeddings}. "
                "The embeddings are plotted without an additional "
                "dimensionality reduction.",
                UserWarning,
            )
            basis = "embeddings"
        else:
            basis = method

        if color is None:
            color = "color_embeddings"
            for asigs in self.asignatures.values():
                asigs.obs[color] = asigs.n_obs * ["black"]
            self.mdata.obs[color] = self.mdata.n_obs * ["#1f77b4"]
        if zorder is None:
            zorder = "zorder_embeddings"
            for asigs in self.asignatures.values():
                asigs.obs[zorder] = asigs.n_obs * [2]
            self.mdata.obs[zorder] = self.mdata.n_obs * [1]
        if annotations is None:
            annotations = sum(self.signature_names.values(), [])

        ax = pl.embedding_multiple(
            adatas=adatas, basis=basis, dimensions=dimensions, color=color,
            zorder=zorder, annotations=annotations, **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax

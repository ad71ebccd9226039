from .ensemble import fit_gp_ensemble
from .fallback import FallbackResult, fit_logreg_batch, nearest_subsample
from .variational import GPFitResult, fit_gp, fit_gp_batch, init_params

__all__ = [
    "GPFitResult",
    "fit_gp",
    "fit_gp_batch",
    "fit_gp_ensemble",
    "init_params",
    "FallbackResult",
    "fit_logreg_batch",
    "nearest_subsample",
]

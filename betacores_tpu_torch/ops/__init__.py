from .._lazy import lazy_namespace

_NAMES = {
    "projection": ("Groups", "center", "draw_subsample", "project_beta",
                   "project_beta_with_grad", "project_groups", "project_ll",
                   "project_ll_with_grad"),
}

__all__ = ["kernels", "projection", "Groups", "center", "draw_subsample", "project_beta",
           "project_beta_with_grad", "project_groups", "project_ll", "project_ll_with_grad"]

__getattr__, __dir__ = lazy_namespace(__name__, _NAMES, ("kernels", "projection"))

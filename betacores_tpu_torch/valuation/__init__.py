"""Group-level data valuation (counterpart of betacores_tpu/valuation)."""

from .shapley import (capped_member_mask, logreg_laplace_value_fn, make_dshapley,
                      make_tmc_shapley)

__all__ = ["capped_member_mask", "logreg_laplace_value_fn", "make_dshapley",
           "make_tmc_shapley"]

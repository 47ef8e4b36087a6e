"""AIR constraint sets of the stwo prover and verifier.

Port of ``stark_symphony_tpu/models/stwo/constraints.py``: an AIR is a
function ``(log_size, oods_point, oods_trace, coeff)`` that returns the
composition polynomial's value at the OODS point (``REGISTRY``), plus its
trace recurrence (``TRACE_RULES``, Python ints mod P, for the prover's
trace) and its M31 rule on LDE values (``lde_rule``, for the prover's
composition polynomial).  ``AIR_IDS`` orders the AIRs for routed
verification: a proof's ``air_id`` indexes it.
"""

from __future__ import annotations

from ...ops import field as F
from ...ops.circle import vanishing_poly_eval


def _fold_columns(rule_qm31, log_size, oods_point, oods_trace, random_coeff):
    """Random-linear-combine per-column constraints c_k = rule(c_{k-2},
    c_{k-1}) and divide by the vanishing polynomial.

    oods_trace: (..., n_columns, 4); the first two columns seed (a, b)."""
    n_columns = oods_trace.shape[-2]
    acc = F.qm31_zero(oods_trace.shape[:-2], oods_trace.device)
    a = oods_trace[..., 0, :]
    b = oods_trace[..., 1, :]
    for col in range(2, n_columns):
        c = oods_trace[..., col, :]
        constraint = F.qm31_sub(c, rule_qm31(a, b))
        acc = F.qm31_add(F.qm31_mul(acc, random_coeff), constraint)
        a, b = b, c
    vanish = vanishing_poly_eval(log_size, oods_point)
    return F.qm31_div(acc, vanish)


def wide_fibonacci(log_size, oods_point, oods_trace, random_coeff):
    """Wide-Fibonacci AIR: c = b^2 + a^2 across columns."""
    rule = lambda a, b: F.qm31_add(F.qm31_sqr(b), F.qm31_sqr(a))
    return _fold_columns(rule, log_size, oods_point, oods_trace, random_coeff)


def wide_product(log_size, oods_point, oods_trace, random_coeff):
    """Wide-product AIR: c = a * b across columns."""
    return _fold_columns(F.qm31_mul, log_size, oods_point, oods_trace,
                         random_coeff)


REGISTRY = {
    "wide_fibonacci": wide_fibonacci,
    "wide_product": wide_product,
}

# AIR order for routed verification: air_id indexes this.
AIR_IDS = ("wide_fibonacci", "wide_product")

# Trace recurrences (Python ints mod P), keyed as REGISTRY.
TRACE_RULES = {
    "wide_fibonacci": lambda a, b: (a * a + b * b),
    "wide_product": lambda a, b: (a * b),
}


def lde_rule(air: str):
    """The M31 constraint rule on LDE values, for the prover."""
    if air == "wide_fibonacci":
        return lambda a, b: F.m31_add(F.m31_sqr(a), F.m31_sqr(b))
    if air == "wide_product":
        return lambda a, b: F.m31_mul(a, b)
    raise KeyError(air)

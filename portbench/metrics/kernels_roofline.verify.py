"""The verify kernels' share of their roofline: the least time an H100
takes for the SHA-256 work of the stretch's proofs, counted from the
configuration (``rooflines/sha256_work.py``), over the device time of the
kernels that do it (``rooflines/kernels.json``) in the traced stretch."""

from portbench.rooflines import sha256_work as W


def read(ctx):
    p = ctx.profile
    spent = p.kernel_s(W.kernel_names()) if p is not None else 0.0
    if spent <= 0:
        return None
    proofs = ctx.cell.traffic["lanes"] * p.units
    work = W.VERIFY[ctx.cell.config["system"]](ctx.cell.config)
    return 100 * work.least_s(proofs) / spent

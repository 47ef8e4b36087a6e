"""Static protocol configuration of the stark101 (FibonacciSq) scheme.

The port's copy of ``stark_symphony_tpu/models/stark101/config.py``: the
same fields and defaults, with the derived field constants computed on the
host from Python ints.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...ops.field101 import GEN, Q


@dataclass(frozen=True)
class Stark101Config:
    domain_size: int = 1024          # trace subgroup size
    blowup: int = 8                  # extension factor
    trace_len: int = 1023
    idx_offset: int = 8              # g = h^idx_offset on the big domain
    boundary0: int = 1               # A_0
    boundary1: int = 2338775057      # A_1022
    x1: int = 3141592                # the secret second trace element

    @property
    def domain_ex_size(self) -> int:
        return self.domain_size * self.blowup  # 8192

    @property
    def log_domain_ex(self) -> int:
        return self.domain_ex_size.bit_length() - 1  # 13

    @property
    def n_fri_layers(self) -> int:
        """Number of committed FRI layers (cp degree 1023 -> 10 folds)."""
        return (self.domain_size - 1).bit_length()  # 10

    @property
    def subgroup_gen(self) -> int:
        """g: generator of the trace subgroup (order domain_size)."""
        return pow(GEN, (3 * 2**30) // self.domain_size, Q)

    @property
    def coset_gen(self) -> int:
        """h: generator of the big subgroup (order domain_ex_size)."""
        return pow(GEN, (3 * 2**30) // self.domain_ex_size, Q)

    def g_pow(self, k: int) -> int:
        return pow(self.subgroup_gen, k, Q)


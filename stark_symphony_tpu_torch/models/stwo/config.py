"""Static protocol configuration for the stwo circle-STARK verifier.

The port's own copy of ``stark_symphony_tpu/models/stwo/config.py``: one
typed config object drives shapes and transcript layout, and
`from_proof_json` derives it from the config embedded in a proof JSON.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StwoConfig:
    trace_log_size: int
    lde_log_size: int
    n_queries: int
    n_inner_layers: int
    pow_bits: int = 5
    n_columns: int = 4
    n_cp_partitions: int = 16
    max_column_offset: int = 1

    @property
    def log_blowup(self) -> int:
        return self.lde_log_size - self.trace_log_size

    @property
    def pow_target(self) -> int:
        """u64 target; digest-derived value must be strictly below.

        5 bits -> 0x07ffffffffffffff (config.simf:31,49)."""
        return (1 << (64 - self.pow_bits)) - 1

    @property
    def final_log_size(self) -> int:
        """Log domain size after the first (circle) fold and all inner
        (line) folds."""
        return self.lde_log_size - 1 - self.n_inner_layers

    def fri_layer_depth(self, layer: int) -> int:
        """Merkle proof depth of FRI layer `layer` (0 = first/circle layer).

        Leaves are hashed in adjacent pairs, so depth = log_size - 1
        (fri/layers.simf:40-48)."""
        return self.lde_log_size - 1 - layer


# TESTING config (config.simf:17-32) — matches tests/data/proof_test.json
TESTING = StwoConfig(
    trace_log_size=3, lde_log_size=4, n_queries=1, n_inner_layers=2, pow_bits=5
)

# Production config (config.simf:35-51) — matches tests/data/proof.json
PRODUCTION = StwoConfig(
    trace_log_size=9, lde_log_size=13, n_queries=16, n_inner_layers=8, pow_bits=5
)

# TESTING-size config with a splittable query axis (n_queries=4) — used by
# the tensor-parallel (query-sharded) tests and the multichip dryrun.
TESTING_Q4 = StwoConfig(
    trace_log_size=3, lde_log_size=4, n_queries=4, n_inner_layers=2,
    pow_bits=5
)


def from_proof_json(data: dict) -> StwoConfig:
    """Derive the config from a stwo proof JSON (its embedded "config" key
    plus structural facts), mirroring generate_wit.py:106-245."""
    cfg = data.get("config", {})
    fri_cfg = cfg.get("fri_config", {})
    n_queries = int(fri_cfg.get("n_queries", 1))
    log_blowup = int(fri_cfg.get("log_blowup_factor", 1))
    pow_bits = int(cfg.get("pow_bits", 5))
    n_inner = len(data["fri_proof"].get("inner_layers", []))
    n_columns = len(data["sampled_values"][1])
    n_cp = len(data["sampled_values"][2])
    # Trace log size is not in the JSON; recover from fold structure:
    # final_log_size = log_last_layer_degree_bound + log_blowup
    last_bound = int(fri_cfg.get("log_last_layer_degree_bound", 0))
    # first fold + inner folds take lde_log down to last_bound + log_blowup
    lde_log = last_bound + log_blowup + 1 + n_inner
    return StwoConfig(
        trace_log_size=lde_log - log_blowup,
        lde_log_size=lde_log,
        n_queries=n_queries,
        n_inner_layers=n_inner,
        pow_bits=pow_bits,
        n_columns=n_columns,
        n_cp_partitions=n_cp,
    )

"""A closed loop of host proof batches through the port's stream
(``parallel/pipeline.StreamVerifier``) over a batched verifier, graphed.

One client feeds host batches back to back; the stream keeps `depth` in
flight, so ``feed`` returns once the batch `depth` before the one it was
handed is verified: that is when the host holds that batch's verdicts.
The batches are `distinct_batches` host batches of `lanes` lanes, drawn by
the seed from the configuration's committed proofs, each with
`tampered_lanes` tampered lanes (``inputs.draw_batch``), fed in turn.

Set-up captures the graph on the first feeds, then keeps feeding for
`warmup_s` seconds before it drains: an H100 runs the same graph about a
quarter slower for the first seconds of a process's load (up to about 13 s
of the stwo stream's load in the runs measured; PERF.md), and the window
starts once that has passed.

Traffic keys: lanes, depth, distinct_batches, tampered_lanes, warmup_s,
profiled_batches (the traced stretch).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import inputs
from portbench.common import quantile, replay_split


def program_config(config: dict):
    """The port's configuration object for the configuration file."""
    if config["system"] == "stwo":
        from stark_symphony_tpu_torch.models.stwo.config import StwoConfig

        return StwoConfig(**config["params"])
    from stark_symphony_tpu_torch.models.stark101.config import Stark101Config

    return Stark101Config(**config["params"])


def verify_fn(config: dict, control: bool = False):
    """The batched verifier the stream graphs: the configuration's
    ``verify_batch``.  The control drops one guarantee the configuration
    states, that every FRI decommitment is checked: its bitmap is the AND
    of every stage's mask but the FRI Merkle masks."""
    cfg = program_config(config)
    if config["system"] == "stwo":
        from stark_symphony_tpu_torch.models.stwo import verifier

        linkage = config["linkage"]
        if not control:
            return lambda b: verifier.verify_batch(b, cfg, linkage=linkage)
        verify = lambda b: verifier.verify(b, cfg, linkage=linkage)
    else:
        from stark_symphony_tpu_torch.models.stark101 import verifier

        if not control:
            return lambda b: verifier.verify_batch(b, cfg)
        verify = lambda b: verifier.verify(b, cfg)

    def weakened(b):
        _, masks = verify(b)
        kept = [m for k, m in masks.items() if not k.startswith("fri_merkle")]
        ok = kept[0]
        for m in kept[1:]:
            ok = ok & m
        return ok

    return weakened


def proof_type(config: dict):
    if config["system"] == "stwo":
        from stark_symphony_tpu_torch.models.stwo.proof import StwoProof

        return StwoProof
    from stark_symphony_tpu_torch.models.stark101.proof import Stark101Proof

    return Stark101Proof


class Driver:
    def __init__(self, cell, seed: int, devs, control: bool = False):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.dev = devs[0]
        self.rng = np.random.default_rng(seed)
        self.control = control
        self.fed = []  # the distinct batch of every feed, in order
        self.bitmaps = []  # host copies, in the order fed

    # --- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        import torch
        from stark_symphony_tpu_torch.parallel.pipeline import StreamVerifier

        t = self.traffic
        self.proofs = inputs.distinct_proofs(self.cell.root, self.config)
        stacked = inputs.stack(self.proofs)
        self.batches = [inputs.draw_batch(self.rng, stacked, t["lanes"], t["tampered_lanes"],
                                          self.config["system"])
                        for _ in range(t["distinct_batches"])]
        kind = proof_type(self.config)
        self.host = [kind(**b.fields) for b in self.batches]
        self.stream = StreamVerifier(verify_fn(self.config, self.control), depth=t["depth"],
                                     device=self.dev)
        self._torch = torch
        for k in range(len(self.host)):  # the first feed captures the graph
            self._feed(k)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < t["warmup_s"]:
            self._feed(len(self.fed) % len(self.host))
        self._drain()

    def _feed(self, k: int) -> None:
        self.stream.feed(self.host[k])
        self.fed.append(k)

    def _drain(self) -> None:
        self.bitmaps += [b.cpu().numpy() for b in self.stream.finish()]

    # --- the window ---------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        k_n = len(self.host)
        depth = self.traffic["depth"]
        lanes = self.traffic["lanes"]
        fed, ret = [], []
        t0 = time.perf_counter()
        while True:
            fed.append(time.perf_counter())
            self._feed(len(fed) % k_n)
            ret.append(time.perf_counter())
            if ret[-1] - t0 >= seconds:
                break
        close = ret[-1]
        last = self.stream.finish()  # the last `depth` batches are held once it returns
        end = time.perf_counter()
        self.bitmaps += [b.cpu().numpy() for b in last]
        n = len(fed)
        held = [ret[j + depth] if j + depth < n else end for j in range(n)]
        latency = [1e3 * (h - f) for f, h in zip(fed, held)]
        in_window = sum(1 for h in held if h <= close)
        out = {"verify_proofs_per_s": in_window * lanes / (close - t0),
               "verify_batch_p95_ms": quantile(latency, 0.95), "attempted": n * lanes,
               "latencies_ms": latency, "seconds": close - t0, "t0": t0}
        steps = [1e3 * (b - a) for a, b in zip(ret, ret[1:])]
        if steps:  # the pace: ms between the returns of two feeds
            out.update(feed_step_ms_median=quantile(steps, 0.5), feed_step_ms_max=max(steps))
        return out

    # --- the trace -------------------------------------------------------------------

    def stretch(self):
        """(fn, units): `profiled_batches` batches fed and drained.  The
        replay split is taken first, before the profiler starts: under it
        every graph launch holds the host many times longer."""
        n = self.traffic["profiled_batches"]
        self._split = None
        if self.dev.type == "cuda":
            self._split = replay_split(self._torch, lambda: self._feed(0))
            self._drain()

        def run():
            for i in range(n):
                self._feed(i % len(self.host))
            self._drain()

        return run, n

    def probe_replay_split(self):
        """One feed's graph replay, taken before the traced stretch: host ms
        inside the replay call against the replay's device span, by CUDA
        events."""
        return getattr(self, "_split", None)

    def probe_stage_vi_ms(self):
        """Stage VI's graphed ms at the cell's batch, from the port's
        per-stage profiler, on the first host batch."""
        if self.config["system"] != "stwo" or self.dev.type != "cuda":
            return None
        from stark_symphony_tpu_torch.tools import profile_verify as PV
        from stark_symphony_tpu_torch.models.stwo import proof as P

        calls = PV.standard_calls(P.to_torch(self.host[0], str(self.dev)),
                                  program_config(self.config))
        name, fn, args = next(c for c in calls if c[0] == "stage_vi")
        return PV.time_stage(name, fn, args, 3, self.traffic["lanes"])["ms_per_batch"]

    # --- after the run ------------------------------------------------------------

    def release(self) -> None:
        """Collect every bitmap and free the device state."""
        self._drain()
        self.stream = None
        if self.dev.type == "cuda":
            self._torch.cuda.synchronize(self.dev)
            self._torch.cuda.empty_cache()

    def check(self) -> tuple:
        """(numbers, failed): every bitmap against the reference's verdicts."""
        want = inputs.expected(self.batches, self.proofs, self.config)
        wrong = sum(int(np.count_nonzero(bm.astype(bool) != want[k]))
                    for k, bm in zip(self.fed, self.bitmaps))
        missing = abs(len(self.fed) - len(self.bitmaps))
        return [("wrong_verdicts", wrong, 0), ("missing_batches", missing, 0)], wrong + missing

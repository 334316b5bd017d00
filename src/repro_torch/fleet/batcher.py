"""Signature grouping + batch-size bucketing: never rebuild for a wobble.

Port of ``repro.fleet.batcher``. Request arrival rates wobble, and an entry
point per *exact* batch size would rebuild the stacked pair list (and its
incoming table) on the serving hot path; each batch is padded up to a
power-of-two **batch bucket** with a no-shrink policy instead
(:class:`~repro_torch.distributed.transport.BucketPolicy`), so arrival
sizes 3, 7, 5, 8 build exactly two entry points (buckets 4 and 8), not
four — counted by ``CompileProbe`` in ``tests/test_torch_fleet.py``.

Batches are formed per signature in admission order, capped at
``max_batch``; ``min_bucket`` is the reference's fleet-mesh divisor, 1 on
the port's one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..distributed.transport import BucketPolicy
from .queue import FleetRequest

# a bucket that has grown never shrinks: recompiling a serving entry point
# costs more than any padded lane ever will
NO_SHRINK = 10 ** 9


@dataclass
class Batch:
    """Same-signature requests to be served by one stacked program."""
    signature_key: str
    requests: List[FleetRequest]
    bucket: int                       # padded batch size (power of two)

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def pad(self) -> int:
        return self.bucket - len(self.requests)


class SignatureBatcher:
    """Group ready requests by signature; bucket each group's batch size."""

    def __init__(self, *, max_batch: int = 64, min_bucket: int = 1):
        self.max_batch = int(max_batch)
        self.policy = BucketPolicy(min_bucket=min_bucket,
                                   shrink_patience=NO_SHRINK)

    def form(self, ready: List[FleetRequest]) -> List[Batch]:
        """Admission-ordered batches: one per (signature, ≤max_batch chunk).

        Groups keep arrival order (first request of a signature anchors its
        group's position) so no signature can be starved by a busier one.
        """
        groups: Dict[str, List[FleetRequest]] = {}
        order: List[str] = []
        for r in ready:
            if r.signature_key not in groups:
                groups[r.signature_key] = []
                order.append(r.signature_key)
            groups[r.signature_key].append(r)
        batches: List[Batch] = []
        for key in order:
            reqs = groups[key]
            for lo in range(0, len(reqs), self.max_batch):
                chunk = reqs[lo:lo + self.max_batch]
                bucket = self.policy.fit(key, len(chunk))
                batches.append(Batch(signature_key=key, requests=chunk,
                                     bucket=bucket))
        return batches

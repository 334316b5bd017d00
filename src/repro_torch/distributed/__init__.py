"""Distribution layer of the port: the halo transport of the distributed
time-bin engine (``transport.py``). The reference's sharding rules,
overlapped collectives and pipeline placement serve the LM zoo (ROADMAP
queue 1 item 13) and are not here."""

from .transport import (DYNAMIC_STATE_FIELDS, RESIDENCIES, TRANSPORTS,
                        BucketPolicy, CompileProbe, HostTransport,
                        ProgramCache, ResidentBuffers, ShipSlots,
                        TransferProbe, Transport,
                        make_transport, next_pow2, pack_allgather,
                        pack_rounds)

__all__ = [
    "DYNAMIC_STATE_FIELDS", "RESIDENCIES", "TRANSPORTS", "BucketPolicy",
    "CompileProbe", "HostTransport", "ProgramCache", "ResidentBuffers",
    "ShipSlots",
    "TransferProbe", "Transport", "make_transport", "next_pow2",
    "pack_allgather", "pack_rounds",
]

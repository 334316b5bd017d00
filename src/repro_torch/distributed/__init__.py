"""Distribution layer of the port: the halo transport of the distributed
time-bin engine (``transport.py``) and the gradient compression with error
feedback (``compression.py``, single-device). The reference's sharding
rules, overlapped collectives and pipeline placement serve a multi-device
mesh and are out of scope (README)."""

from .compression import (CompressState, compress_grads, compressed_bytes,
                          decompress_grads, init_compress_state)

from .transport import (DYNAMIC_STATE_FIELDS, RESIDENCIES, TRANSPORTS,
                        BucketPolicy, CompileProbe, HostTransport,
                        ProgramCache, ResidentBuffers, ShipSlots,
                        TransferProbe, Transport,
                        make_transport, next_pow2, pack_allgather,
                        pack_rounds)

__all__ = [
    "CompressState", "compress_grads", "compressed_bytes",
    "decompress_grads", "init_compress_state",
    "DYNAMIC_STATE_FIELDS", "RESIDENCIES", "TRANSPORTS", "BucketPolicy",
    "CompileProbe", "HostTransport", "ProgramCache", "ResidentBuffers",
    "ShipSlots",
    "TransferProbe", "Transport", "make_transport", "next_pow2",
    "pack_allgather", "pack_rounds",
]

"""PyTorch/CUDA port of the SWIFT reproduction (``repro``).

The JAX package ``repro`` is the reference; this package re-implements its
slices in PyTorch, with every Pallas kernel of a ported slice replaced by a
kernel written by hand for NVIDIA Hopper (``kernels/``). The layout mirrors
the reference, so each module's counterpart carries the same name; the
host-side planning of ``core/`` (task graph, scheduler, partitioner, cost
model, comm planner, decomposition) is a numpy copy of the reference's.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""

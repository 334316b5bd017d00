"""Observability for the port: the span tracer and the host-side telemetry
rows the single-host ladder fills."""

from .tracer import NULL_TRACER, NullTracer, Span, Tracer

__all__ = ["NULL_TRACER", "NullTracer", "Span", "Tracer"]

"""Shared utilities: metrics, tracing, clock helpers."""

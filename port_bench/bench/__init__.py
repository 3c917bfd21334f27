"""Shared harness: registry, guards, weights, pools, spans, trace reduction, results."""

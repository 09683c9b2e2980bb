"""Numeric ops.

``hostref`` holds exact host-side (numpy, f64) implementations used for
clip preparation at init time, QA/differential testing, and rare-overflow
fallbacks. The sibling modules (`correlate`, `loudness`, `peaks`, `verify`)
hold the JAX device code that carry the streaming hot path.
"""

"""The benchmark's harness: one driver a kind of traffic, and what they
share (weights, traffic, the trace, the checks)."""

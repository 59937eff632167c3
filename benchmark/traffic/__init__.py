"""Traffic kinds: one module a kind, found by the cell's ``traffic.kind``."""

"""The device planner's reach kernel (no counterpart in ``repro``: the
reference plans on the host)."""

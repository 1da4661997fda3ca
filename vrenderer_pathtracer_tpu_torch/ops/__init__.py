"""Per-lane operators: intersection, shading, tonemap."""

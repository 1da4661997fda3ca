"""Counter-based RNG and camera."""

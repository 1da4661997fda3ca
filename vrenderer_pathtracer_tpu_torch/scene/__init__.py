"""Scene content and backend resolution."""

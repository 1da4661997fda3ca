"""Integrator, the radiance kernel wrapper and the Renderer."""

"""Timing and throughput bookkeeping."""

"""Inverse rendering: trainable parameters and the train steps."""

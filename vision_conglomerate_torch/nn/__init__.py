"""Modules of the detection main path."""

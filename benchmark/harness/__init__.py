"""The benchmark's general harness: it reads a cell's files by name and
runs the port on them (see main.py)."""

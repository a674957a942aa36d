"""The benchmark's plain reference (``nerf.py``): no kernel, no part of the
program."""

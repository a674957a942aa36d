"""The harness: one module per kind of cell (``train``, ``render``), each
with ``run(ctx) -> dict``, and what they share."""

"""The JAX package's kernel probes (``experiments/``), run on the card.

Each module runs with ``python -m`` and prints the lines of its JAX
script: :mod:`.triangle_timepack` (the moving-boundary mask of time
packing, through K6) and :mod:`.packed_step_variants` (the packed step's
variants A-E, through K7).
"""

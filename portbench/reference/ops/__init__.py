"""One reference stage per file, named after the config's op:
``apply(x, dtype, info, **params)`` on [B, H, W] and
``operations(shape, info, **params)``, the float operations the stage
needs for a batch of ``shape`` (the counts of PERF.md's kernel table)."""

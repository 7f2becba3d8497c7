"""Seeded input phantoms, one file each: ``make(batch, h, w, generator,
device)`` returns a batch of raw slices in the configuration's io dtype,
made on ``device`` from ``generator`` alone."""

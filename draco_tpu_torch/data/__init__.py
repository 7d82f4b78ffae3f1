"""Data pipeline of the port: datasets, batching, augmentation, chunk
prefetch."""

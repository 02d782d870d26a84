"""Host runtime: batch and trait-block planning, prefetch, checkpoints,
scheduling backends and device resolution."""

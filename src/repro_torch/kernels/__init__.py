"""Hand-written Hopper kernels (``csrc/``) and their wrappers."""

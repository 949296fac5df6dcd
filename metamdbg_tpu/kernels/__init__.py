"""Device kernels (JAX/XLA): batch sketching, k-min-mer row counting and
banded anchor-chaining DP, each the bit-identical twin of a host path."""

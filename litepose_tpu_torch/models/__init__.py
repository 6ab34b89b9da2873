"""LitePose as ``nn.Module``s, its seeded init, and the weight bridge to
and from the JAX pytrees."""

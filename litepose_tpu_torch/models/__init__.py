"""LitePose as ``nn.Module``s, and the weight bridge from the JAX pytrees."""

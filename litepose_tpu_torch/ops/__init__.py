"""Decode: NMS + top-M peaks (K1), greedy (K2) or Hungarian (K3) AE
grouping, and refine (K4), each a CUDA kernel with a plain PyTorch twin."""

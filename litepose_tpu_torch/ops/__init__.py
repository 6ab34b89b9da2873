"""Decode: NMS + top-M peaks (K1) and greedy AE grouping (K2), each a CUDA
kernel with a plain PyTorch twin."""

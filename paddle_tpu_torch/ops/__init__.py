"""Operators of the port: ``kernels`` holds the hand-written Hopper kernels."""

"""Tensor ops of the port: resampling, attention (Hopper kernel), dense CRF."""

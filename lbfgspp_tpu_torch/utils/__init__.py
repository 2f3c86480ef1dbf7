"""Objectives and helpers of the PyTorch port."""

"""Datasets for the port: synthetic scenes with exact ground truth."""

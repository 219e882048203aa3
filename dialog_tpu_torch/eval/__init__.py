"""Evaluation: trajectory error metrics and trajectory export."""

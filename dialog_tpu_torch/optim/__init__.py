"""Optimizers: Levenberg-Marquardt helpers, motion-only BA and local BA."""

from .pose_only import pose_optimization  # noqa: F401

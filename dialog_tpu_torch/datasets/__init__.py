"""Datasets for the port: synthetic scenes with exact ground truth, the TUM,
KITTI and EuRoC sequence loaders (PNG decoded by ``png``, no cv2) and the
background prefetcher."""

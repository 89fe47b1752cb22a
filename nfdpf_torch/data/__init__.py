"""Disk-tracking data: the simulator and the npz dataset pipeline."""

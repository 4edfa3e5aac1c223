"""Utilities of the port (the counterpart of seaweedfs_tpu/util)."""

"""Storage layer: the volume index and superblock formats the EC encoder
reads, and erasure coding, file-format compatible with seaweedfs_tpu."""

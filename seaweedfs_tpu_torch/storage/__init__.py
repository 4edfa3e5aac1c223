"""Storage layer: needles, volumes (needle-map kinds, disk/mmap/memory
backends, the object-store tier), the store of a volume server, and
erasure coding, file-format compatible with seaweedfs_tpu."""
